"""Depth-window grouping and select: the CUDA kernels, their wrappers, dispatch.

Counterpart of ``frustum_convnet_tpu/ops/select_pallas.py``. The kernels in
``csrc/group_depth_point.cu`` replace its three Pallas kernels:

* ``group_depth_point_multi_cuda``: every scale in one launch, for the
  Pallas ``group_depth_point_multi`` (``select_pallas.py:361``,
  ``pallas_call`` at :402);
* ``group_depth_point_cuda``: one scale, the same kernel with a one-scale
  section table, for ``group_depth_point_pallas`` (:290, :314);
* ``query_depth_point_cuda``: select only (gather indices), for
  ``query_depth_point_pallas`` (:241, :261).

Each ``*_auto`` dispatch is the counterpart of the JAX one
(``group_depth_point_multi_auto`` :435, ``group_depth_point_auto`` :449): a
CPU tensor runs the plain PyTorch version (``ops/query_depth_point``), a
CUDA tensor launches the kernel or raises. The two agree bit for bit. Each
wrapper counts its own launches in ``<wrapper>.launches``. None has a
backward: the points are inputs of the model, never parameters.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from frustum_convnet_tpu_torch.ops import query_depth_point as qdp
from frustum_convnet_tpu_torch.ops._build import load_library

KERNEL_SOURCE = "frustum_convnet_tpu_torch/csrc/group_depth_point.cu"
# the TPU kernel each wrapper replaces (file:line of the function; its
# pallas_call follows in the same function)
REPLACES = {
    "group_depth_point_multi": "frustum_convnet_tpu/ops/select_pallas.py:361",
    "group_depth_point": "frustum_convnet_tpu/ops/select_pallas.py:290",
    "query_depth_point": "frustum_convnet_tpu/ops/select_pallas.py:241",
}
_MAX_SMEM = 227 * 1024  # bytes of dynamic shared memory a Hopper block may opt into

_meta_cache: dict = {}


def _lib() -> ctypes.CDLL:
    lib = load_library("group_depth_point")
    if lib.fcn_group_depth_point_multi.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fcn_group_depth_point_multi.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.fcn_group_depth_point_multi.restype = i32
        lib.fcn_query_depth_point.argtypes = [
            ptr, ptr, ctypes.c_float, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.fcn_query_depth_point.restype = i32
        lib.fcn_cuda_error_string.argtypes = [i32]
        lib.fcn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.fcn_cuda_error_string(err).decode())


def _check_points(points: torch.Tensor, min_channels: int, name: str) -> None:
    """Device, dtype, rank, contiguity, no gradient; the grid's batch range."""
    if points.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {points.device}")
    rank = 3 if min_channels else 2
    if (points.dtype != torch.float32 or points.dim() != rank
            or (min_channels and points.shape[2] < min_channels)):
        want = "(B, N, C>=3)" if min_channels else "(B, N)"
        raise ValueError(f"{name} must be {want} float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    if not points.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if points.requires_grad:
        raise ValueError(f"{name} requires grad, but the kernel has no "
                         "backward (the points are inputs, not parameters)")
    if not 1 <= points.shape[0] <= 65535:
        raise ValueError(f"batch {points.shape[0]} outside the grid's y range "
                         "[1, 65535]")
    if torch.cuda.get_device_capability(points.device) != (9, 0):
        raise RuntimeError("the kernel is built for sm_90a (Hopper) only")


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _section_meta(ms, ks, dis_zs, channels: int, device: torch.device):
    """Per-section (K_i, M_i, index in scale, grouped prefix, count prefix)
    int64 rows and float32 windows over the concatenated sections, cached
    per scale layout and device (they do not depend on the batch size)."""
    key = (tuple(ms), tuple(ks), tuple(float(d) for d in dis_zs), channels,
           str(device))
    if key not in _meta_cache:
        rows, dz = [], []
        g_prefix = c_prefix = 0
        for m, k, d in zip(ms, ks, dis_zs):
            for i in range(m):
                rows.append((k, m, i, g_prefix, c_prefix))
            dz += [np.float32(d)] * m
            g_prefix += m * k * channels
            c_prefix += m
        _meta_cache[key] = (
            torch.tensor(np.asarray(rows, np.int64), device=device),
            torch.tensor(np.asarray(dz, np.float32), device=device))
    return _meta_cache[key]


def _launch_group(points: torch.Tensor, refs, dis_zs, nsamples):
    """One launch of the grouping kernel over the scales ``refs``; the
    callers count it."""
    _check_points(points, 3, "points")
    if not (len(refs) == len(dis_zs) == len(nsamples) >= 1):
        raise ValueError("refs, dis_zs and nsamples must match in length")
    b, n, c = points.shape
    for r in refs:
        if (r.device != points.device or r.dtype != torch.float32
                or r.dim() != 3 or r.shape[0] != b or r.shape[2] != 3):
            raise ValueError(f"each ref must be (B={b}, M, 3) float32 on "
                             f"{points.device}, got {tuple(r.shape)} "
                             f"{r.dtype} {r.device}")
    ks = [int(k) for k in nsamples]
    if any(k < 1 or k > n for k in ks):
        raise ValueError(f"nsamples {ks} must lie in [1, N={n}]")
    if n * c * 4 > _MAX_SMEM:
        raise ValueError(f"a row of N*C={n * c} floats exceeds the "
                         f"{_MAX_SMEM} B of shared memory a block may use")

    ms = [int(r.shape[1]) for r in refs]
    meta, dz = _section_meta(ms, ks, dis_zs, c, points.device)
    ref_cat = torch.cat([r.contiguous() for r in refs], dim=1)
    sizes = [b * m * k * c for m, k in zip(ms, ks)]
    grouped = torch.empty(sum(sizes), dtype=torch.float32, device=points.device)
    cnt = torch.empty(b * sum(ms), dtype=torch.int32, device=points.device)

    lib = _lib()
    stream = torch.cuda.current_stream(points.device).cuda_stream
    err = lib.fcn_group_depth_point_multi(
        points.data_ptr(), ref_cat.data_ptr(), meta.data_ptr(), dz.data_ptr(),
        grouped.data_ptr(), cnt.data_ptr(), b, n, c, sum(ms),
        _device_index(points), stream)
    _check_launch(lib, err, "group_depth_point")

    outs, g_off, c_off = [], 0, 0
    for m, k, size in zip(ms, ks, sizes):
        outs.append((grouped[g_off:g_off + size].view(b, m, k, c),
                     cnt[c_off:c_off + b * m].view(b, m)))
        g_off += size
        c_off += b * m
    return outs


def group_depth_point_multi_cuda(points: torch.Tensor, refs, dis_zs, nsamples):
    """Every grouping scale in one launch of the CUDA kernel.

    points (B, N, C) float32 CUDA, contiguous, xyz in channels 0:3;
    refs [(B, M_i, 3)] float32 on the same device; per-scale window
    ``dis_zs[i]`` (compared in float32) and slot count ``nsamples[i]``.
    Returns ``[(grouped (B, M_i, K_i, C) float32, cnt (B, M_i) int32)]``,
    views of one flat buffer laid out scale by scale.
    """
    outs = _launch_group(points, refs, dis_zs, nsamples)
    group_depth_point_multi_cuda.launches += 1
    return outs


group_depth_point_multi_cuda.launches = 0  # kernel launches since the last reset


def group_depth_point_cuda(points: torch.Tensor, ref: torch.Tensor,
                           dis_z: float, nsample: int):
    """One grouping scale: the same kernel launched with a one-scale section
    table. points (B, N, C), ref (B, M, 3) float32 CUDA -> grouped
    (B, M, K, C) float32, cnt (B, M) int32."""
    ((grouped, cnt),) = _launch_group(points, [ref], [dis_z], [nsample])
    group_depth_point_cuda.launches += 1
    return grouped, cnt


group_depth_point_cuda.launches = 0


def query_depth_point_cuda(z_points: torch.Tensor, z_ref: torch.Tensor,
                           dis_z: float, nsample: int):
    """Select only: z_points (B, N), z_ref (B, M) float32 CUDA, contiguous
    -> idx (B, M, K) int32 gather indices and cnt (B, M) int32."""
    _check_points(z_points, 0, "z_points")
    b, n = z_points.shape
    if (z_ref.device != z_points.device or z_ref.dtype != torch.float32
            or z_ref.dim() != 2 or z_ref.shape[0] != b
            or not z_ref.is_contiguous()):
        raise ValueError(f"z_ref must be a contiguous (B={b}, M) float32 "
                         f"tensor on {z_points.device}, got "
                         f"{tuple(z_ref.shape)} {z_ref.dtype} {z_ref.device}")
    k = int(nsample)
    if not 1 <= k <= n:
        raise ValueError(f"nsample {k} must lie in [1, N={n}]")
    if n * 4 > _MAX_SMEM:
        raise ValueError(f"a row of N={n} depths exceeds the {_MAX_SMEM} B "
                         "of shared memory a block may use")
    m = int(z_ref.shape[1])
    idx = torch.empty((b, m, k), dtype=torch.int32, device=z_points.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=z_points.device)

    lib = _lib()
    stream = torch.cuda.current_stream(z_points.device).cuda_stream
    err = lib.fcn_query_depth_point(
        z_points.data_ptr(), z_ref.data_ptr(), float(np.float32(dis_z)),
        idx.data_ptr(), cnt.data_ptr(), b, n, m, k, _device_index(z_points),
        stream)
    _check_launch(lib, err, "query_depth_point")
    query_depth_point_cuda.launches += 1
    return idx, cnt


query_depth_point_cuda.launches = 0


def _dispatch(t: torch.Tensor, plain, kernel, *args):
    if t.device.type == "cpu":
        return plain(*args)
    if t.device.type == "cuda":
        return kernel(*args)
    raise ValueError(f"no grouping op for device {t.device}")


def group_depth_point_multi_auto(points: torch.Tensor, refs, dis_zs, nsamples):
    """Dispatch on the tensor's device: the plain PyTorch version for a CPU
    tensor, the CUDA kernel for a CUDA tensor (which raises on anything it
    does not take; there is no fallback)."""
    return _dispatch(points, qdp.group_depth_point_multi,
                     group_depth_point_multi_cuda, points, refs, dis_zs, nsamples)


def group_depth_point_auto(points: torch.Tensor, ref: torch.Tensor,
                           dis_z: float, nsample: int):
    """The single-scale grouping, dispatched on the device as above."""
    return _dispatch(points, qdp.group_depth_point, group_depth_point_cuda,
                     points, ref, dis_z, nsample)


def query_depth_point_auto(z_points: torch.Tensor, z_ref: torch.Tensor,
                           dis_z: float, nsample: int):
    """The select only, dispatched on the device as above."""
    return _dispatch(z_points, qdp.query_depth_point, query_depth_point_cuda,
                     z_points, z_ref, dis_z, nsample)
