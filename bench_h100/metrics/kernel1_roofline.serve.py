"""Kernel 1 (``group_depth_point_kernel``) in the traced stretch of a serve
run: the least time its launches could take on these inputs
(``frozen.kernel1_cost.launch_bound``, summed over the launches) over the
device time the trace gives them. Nothing is read when the trace holds
another number of launches than the stretch makes."""

from bench_h100.frozen.kernel1_cost import KERNEL_NAME


def read(ctx):
    summary = ctx.get("trace")
    if ctx["job"] != "serve" or summary is None or ctx.get("kernel1_bound_s") is None:
        return None
    launches, seconds = summary.kernel(KERNEL_NAME)
    if launches != ctx["kernel1_launches"] or seconds <= 0:
        return None
    return 100.0 * ctx["kernel1_bound_s"] / seconds
