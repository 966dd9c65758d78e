"""Bytes and operations of one launch of kernel 1 (``group_depth_point_kernel``).

Frozen copy of ``selected_hits`` and ``kernel_bound`` (grouping modes) from
``frustum_convnet_tpu_torch/tools/time_grouping.py`` at commit 90a8981, with
the peaks beside them. The bound is the larger of the bytes (each input
read once, each output written once) over the HBM rate and the float32
operations (a subtract and a compare per selected hit, three subtracts per
slot) over the float32 instruction rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
# H100 SXM float32 instructions outside the tensor cores: the data sheet's
# 67 TFLOP/s counts each fused multiply-add as two operations, and the
# subtracts and compares counted here are one instruction each
FP32_OPS_PER_S = 67e12 / 2
KERNEL_NAME = "group_depth_point_kernel"


def selected_hits(z_points, z_ref, dis_z: float, k: int) -> int:
    """Hits an exact select takes on these inputs: the sum over sections of
    min(hits, K), which is the sum of its cnt. z_points (B, N), z_ref (B, M)."""
    total = 0
    for b in range(0, z_points.shape[0], 32):  # in slices, to bound the memory
        zp, zr = z_points[b:b + 32], z_ref[b:b + 32]
        hits = ((zp[:, None, :] - zr[:, :, None]).abs() < dis_z).sum(dim=-1)
        total += int(hits.clamp(max=k).sum())
    return total


def launch_bound(points, refs, dzs, ks) -> dict:
    """The least seconds one launch on ``points`` (B, N, C) and ``refs``
    [(B, M_i, 3)] could take, with its bytes and operations."""
    b, n, c = points.shape
    ms = [int(r.shape[1]) for r in refs]
    hits = sum(selected_hits(points[..., 2], r[..., 2], d, int(k))
               for r, d, k in zip(refs, dzs, ks))
    slots = b * sum(m * int(k) for m, k in zip(ms, ks))
    moved = 4 * (b * n * c + 3 * b * sum(ms) + slots * c + b * sum(ms))
    ops = 2 * hits + 3 * slots
    return {"seconds": max(moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S),
            "bytes": moved, "operations": ops}
