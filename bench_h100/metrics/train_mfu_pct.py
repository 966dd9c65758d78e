"""Whole training step: three times the model's forward operations a
frustum (``frozen.flops``) times the run's frustums a second, as a share of
the H100's 67 TFLOP/s of float32 outside the tensor cores (the recipe
computes in float32 with TF32 off)."""

from bench_h100.frozen.flops import TRAIN_FLOPS_MULT, flops_per_frustum

PEAK_FLOPS = 67e12


def read(ctx):
    if ctx["job"] != "train":
        return None
    return 100.0 * TRAIN_FLOPS_MULT * flops_per_frustum(ctx["spec"]) * ctx["rate"] / PEAK_FLOPS
