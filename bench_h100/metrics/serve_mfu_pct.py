"""Whole serving step: the model's forward operations a frustum
(``frozen.flops.flops_per_frustum``) times the run's frustums a second, as a
share of the H100's 67 TFLOP/s of float32 outside the tensor cores (the
configuration computes in float32 with TF32 off)."""

from bench_h100.frozen.flops import flops_per_frustum

PEAK_FLOPS = 67e12


def read(ctx):
    if ctx["job"] != "serve":
        return None
    return 100.0 * flops_per_frustum(ctx["spec"]) * ctx["rate"] / PEAK_FLOPS
