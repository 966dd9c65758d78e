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

``depth_bin_candidates`` mirrors the select kernel's depth-bin prefilter in
float32 on the CPU, for the tests that hold it to a superset of the hits.

Each ``*_auto`` dispatch is the counterpart of the JAX one
(``group_depth_point_multi_auto`` :435, ``group_depth_point_auto`` :449): a
CPU tensor runs the plain PyTorch version (``ops/query_depth_point``), a
CUDA tensor launches the kernel or raises. The two agree bit for bit. Each
wrapper counts its own launches in ``<wrapper>.launches``. None has a
backward: the points are inputs of the model, never parameters.
"""

from __future__ import annotations

import ctypes
import heapq

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
_MAX_SMEM = 227 * 1024  # bytes of shared memory a Hopper block may opt into
_STATIC_SMEM = 256  # at least either kernel's static shared memory
_MAX_WARPS = 8  # warps of a grouping block (kMaxWarps)
_SELECT_WARPS = 16  # most warps of a select block (kSelectWarps)
_MAX_REF_PTRS = 16  # ref pointers a grouping launch takes (kMaxRefPtrs)
_BIN_BYTES = 32 * 1024  # shared memory the select's depth-bin bitmaps may take

_plans: dict = {}
_select_plans: dict = {}
_devices: dict = {}


def _lib() -> ctypes.CDLL:
    lib = load_library("group_depth_point")
    if lib.fcn_group_depth_point_multi.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fcn_group_depth_point_multi.argtypes = [
            ptr, ptr, ptr, i32, ptr, ptr, ptr, i32, ptr, ptr, i32, i32, i32,
            i32, i32, i32, ptr]
        lib.fcn_group_depth_point_multi.restype = i32
        lib.fcn_group_smem_bytes.argtypes = [i32, i32, i32, i32]
        lib.fcn_group_smem_bytes.restype = ctypes.c_size_t
        lib.fcn_select_smem_bytes.argtypes = [i32, i32, i32, i32]
        lib.fcn_select_smem_bytes.restype = ctypes.c_size_t
        lib.fcn_query_depth_point.argtypes = [
            ptr, ptr, ctypes.c_float, ptr, ptr, i32, i32, i32, i32, i32, i32,
            i32, i32, ptr]
        lib.fcn_query_depth_point.restype = i32
        lib.fcn_cuda_error_string.argtypes = [i32]
        lib.fcn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.fcn_cuda_error_string(err).decode())


def _device(t: torch.Tensor) -> tuple:
    """(index, SM count) of ``t``'s card; raises unless it is a Hopper card.
    Queried once per device."""
    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    if index not in _devices:
        props = torch.cuda.get_device_properties(index)
        _devices[index] = ((props.major, props.minor) == (9, 0),
                           props.multi_processor_count)
    hopper, sms = _devices[index]
    if not hopper:
        raise RuntimeError("the kernel is built for sm_90a (Hopper) only")
    return index, sms


def _check_points(points: torch.Tensor, min_channels: int, name: str) -> tuple:
    """Device, dtype, rank, contiguity, no gradient; the grid's batch range.
    Returns the card's (index, SM count)."""
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
    return _device(points)


def num_tiles(batch: int, n_sections: int, sms: int) -> int:
    """Tiles a batch row's sections are dealt into: 3 when the batch alone
    gives two blocks an SM (B=256 then fills the card in one wave of six
    blocks an SM), up to 16 when it does not, never more than the
    sections."""
    return max(1, min(n_sections, 16, max(3, -(-2 * sms // batch))))


def section_table(ms, ks, dis_zs, channels: int, n_tiles: int,
                  per_scale_refs: bool):
    """The grouping launch's section table, on the host.

    One row per section of the concatenated scales (seven int64 columns:
    K_i, M_i, index within the scale, grouped prefix sum_{j<i} M_j*K_j*C,
    count prefix sum_{j<i} M_j, ref pointer slot, float offset of the
    center in the slot's batch row), its float32 window,
    and the tile boundaries: the sections are dealt longest first to the
    tile with the fewest output bytes so far, so every tile's list starts
    with its longest sections. With ``per_scale_refs`` scale i's centers are
    read from ref slot i, else from one concatenated (B, sum M_i, 3) slot 0.
    """
    rows, dz = [], []
    g_prefix = c_prefix = 0
    for s, (m, k, d) in enumerate(zip(ms, ks, dis_zs)):
        for i in range(m):
            slot, col = (s, 3 * i) if per_scale_refs else (0, 3 * (c_prefix + i))
            rows.append((k, m, i, g_prefix, c_prefix, slot, col))
            dz.append(d)
        g_prefix += m * k * channels
        c_prefix += m
    loads = [(0, t) for t in range(n_tiles)]
    tiles = [[] for _ in range(n_tiles)]
    for e in sorted(range(len(rows)), key=lambda e: -rows[e][0]):  # stable
        load, t = heapq.heappop(loads)
        tiles[t].append(e)
        heapq.heappush(loads, (load + rows[e][0] * channels, t))
    order = [e for tile in tiles for e in tile]
    begin = np.cumsum([0] + [len(tile) for tile in tiles]).astype(np.int32)
    return (np.asarray([rows[e] for e in order], np.int64),
            np.asarray([dz[e] for e in order], np.float32), begin)


def output_views(b: int, ms, ks, c: int) -> list:
    """Per scale, the (size, stride, offset) of its grouped (B, M_i, K_i, C)
    and its cnt (B, M_i) in the grouping launch's one buffer, which holds
    every scale's grouped values scale by scale, then every scale's counts."""
    views, g_off = [], 0
    c_off = sum(b * m * k * c for m, k in zip(ms, ks))
    for m, k in zip(ms, ks):
        views.append((((b, m, k, c), (m * k * c, k * c, c, 1), g_off),
                      ((b, m), (m, 1), c_off)))
        g_off += b * m * k * c
        c_off += b * m
    return views


def split_outputs(out: torch.Tensor, views) -> list:
    """``[(grouped float32, cnt int32)]``: ``output_views`` of ``out``."""
    cnt = out.view(torch.int32)
    return [(out.as_strided(*g), cnt.as_strided(*k)) for g, k in views]


class _Plan:
    """What a grouping launch needs besides its pointers, per batch size,
    layout and device: the section table on the device, the launch shape
    and the output views."""

    def __init__(self, lib, b, n, c, ms, ks, dis_zs, per_scale_refs, device, sms):
        self.k_max = max(ks)
        self.warps = _MAX_WARPS
        while (self.warps and lib.fcn_group_smem_bytes(n, c, self.k_max, self.warps)
               + _STATIC_SMEM > _MAX_SMEM):
            self.warps -= 1
        if not self.warps:
            raise ValueError(f"a row of N*C={n * c} floats, its N depths and one "
                             f"staged span of K={self.k_max} slots exceed the "
                             f"{_MAX_SMEM} B of shared memory a block may use")
        self.n_tiles = num_tiles(b, sum(ms), sms)
        self.table, self.dz, self.begin = (
            torch.from_numpy(a).to(device) for a in section_table(
                ms, ks, dis_zs, c, self.n_tiles, per_scale_refs))
        self.ref_rows = [3 * m for m in ms] if per_scale_refs else [3 * sum(ms)]
        self.size = b * sum(m * k * c for m, k in zip(ms, ks)) + b * sum(ms)
        self.views = output_views(b, ms, ks, c)


def _launch_group(points: torch.Tensor, refs, dis_zs, nsamples):
    """One launch of the grouping kernel over the scales ``refs``; the
    callers count it."""
    index, sms = _check_points(points, 3, "points")
    if not (len(refs) == len(dis_zs) == len(nsamples) >= 1):
        raise ValueError("refs, dis_zs and nsamples must match in length")
    b, n, c = points.shape
    device = points.device
    for r in refs:
        if (r.device != device or r.dtype != torch.float32
                or r.dim() != 3 or r.shape[0] != b or r.shape[2] != 3):
            raise ValueError(f"each ref must be (B={b}, M, 3) float32 on "
                             f"{device}, got {tuple(r.shape)} {r.dtype} {r.device}")
    ks = tuple(int(k) for k in nsamples)
    if any(k < 1 for k in ks):  # K > N: the slots past the hits repeat the first
        raise ValueError(f"nsamples {list(ks)} must be at least 1")
    ms = tuple(int(r.shape[1]) for r in refs)
    per_scale_refs = len(refs) <= _MAX_REF_PTRS
    lib = _lib()
    key = (b, n, c, ms, ks, tuple(dis_zs), per_scale_refs, device)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _Plan(lib, b, n, c, ms, ks, dis_zs, per_scale_refs,
                                   device, sms)
    if per_scale_refs:
        refs = [r if r.is_contiguous() else r.contiguous() for r in refs]
    else:
        refs = [torch.cat([r.contiguous() for r in refs], dim=1)]
    out = torch.empty(plan.size, dtype=torch.float32, device=device)
    err = lib.fcn_group_depth_point_multi(
        points.data_ptr(), (ctypes.c_void_p * len(refs))(*[r.data_ptr() for r in refs]),
        (ctypes.c_int64 * len(refs))(*plan.ref_rows), len(refs), plan.table.data_ptr(),
        plan.dz.data_ptr(), plan.begin.data_ptr(), plan.n_tiles, out.data_ptr(),
        out.data_ptr() + 4 * plan.views[0][1][2], b, n, c, plan.k_max, plan.warps,
        index, torch.cuda.current_stream(device).cuda_stream)
    _check_launch(lib, err, "group_depth_point")
    return split_outputs(out, plan.views)


def group_depth_point_multi_cuda(points: torch.Tensor, refs, dis_zs, nsamples):
    """Every grouping scale in one launch of the CUDA kernel.

    points (B, N, C) float32 CUDA, contiguous, xyz in channels 0:3;
    refs [(B, M_i, 3)] float32 on the same device; per-scale window
    ``dis_zs[i]`` (compared in float32) and slot count ``nsamples[i]``.
    Returns ``[(grouped (B, M_i, K_i, C) float32, cnt (B, M_i) int32)]``,
    views of one flat buffer laid out scale by scale.

    It takes any number of scales, as the Pallas kernel does (which
    concatenates the refs, ``select_pallas.py:381``): up to 16 cross to the
    kernel as per-scale pointers, more are concatenated into one.
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
    -> idx (B, M, K) int32 gather indices and cnt (B, M) int32. The launch
    shape is a plan cached per (B, N, M, K, card)."""
    index, sms = _check_points(z_points, 0, "z_points")
    b, n = z_points.shape
    if (z_ref.device != z_points.device or z_ref.dtype != torch.float32
            or z_ref.dim() != 2 or z_ref.shape[0] != b
            or not z_ref.is_contiguous()):
        raise ValueError(f"z_ref must be a contiguous (B={b}, M) float32 "
                         f"tensor on {z_points.device}, got "
                         f"{tuple(z_ref.shape)} {z_ref.dtype} {z_ref.device}")
    k = int(nsample)
    if k < 1:
        raise ValueError(f"nsample {k} must be at least 1")
    m = int(z_ref.shape[1])
    lib = _lib()
    key = (b, n, m, k, index)
    plan = _select_plans.get(key)
    if plan is None:  # (bins, tiles a row, warps a block)
        n_bins = depth_bins(n)
        n_tiles, warps = select_launch(b, m, sms)
        plan = _select_plans[key] = (n_bins, n_tiles,
                                     _select_warps(lib, n, k, n_bins, warps))
    n_bins, n_tiles, warps = plan
    idx = torch.empty((b, m, k), dtype=torch.int32, device=z_points.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=z_points.device)

    stream = torch.cuda.current_stream(z_points.device).cuda_stream
    err = lib.fcn_query_depth_point(
        z_points.data_ptr(), z_ref.data_ptr(), float(np.float32(dis_z)),
        idx.data_ptr(), cnt.data_ptr(), b, n, m, k, n_bins, n_tiles, warps,
        index, stream)
    _check_launch(lib, err, "query_depth_point")
    query_depth_point_cuda.launches += 1
    return idx, cnt


query_depth_point_cuda.launches = 0


def bitmap_words(n: int) -> int:
    """Words of one depth-bin bitmap of the select kernel: a bit a point,
    padded to whole 1024-point chunks (``bitmap_words`` in the source)."""
    return -(-n // 1024) * 32


def depth_bins(n: int) -> int:
    """Depth bins of the select kernel's prefilter for rows of N points: as
    many as fit 32 KB of bitmaps, at most 256 (256 up to N=1024, 128 up to
    2048, 64 up to 4096, ...)."""
    return max(1, min(256, _BIN_BYTES // (4 * bitmap_words(n))))


def select_launch(batch: int, n_sections: int, sms: int) -> tuple:
    """(tiles a row, warps a block) of the select kernel: one block of 16
    warps a row once the batch alone gives every SM a block, so that a
    row's bitmaps are built once; else the grouping's tile count
    (``num_tiles``) in blocks of 8 warps."""
    if batch >= sms:
        return 1, _SELECT_WARPS
    return num_tiles(batch, n_sections, sms), _MAX_WARPS


def _select_warps(lib, n: int, k: int, n_bins: int, warps: int) -> int:
    """``warps``, or fewer where the staged depths, the bitmaps and each
    warp's four staging spans of K ints and candidate lists do not fit in
    shared memory."""
    while warps and lib.fcn_select_smem_bytes(n, k, n_bins, warps) + _STATIC_SMEM > _MAX_SMEM:
        warps -= 1
    if not warps:
        raise ValueError(f"a row of N={n} depths, its {n_bins} depth-bin bitmaps "
                         f"and one staged span of K={k} indices exceed the "
                         f"{_MAX_SMEM} B of shared memory a block may use")
    return warps


def depth_bin_candidates(z_points: torch.Tensor, z_ref: torch.Tensor,
                         dis_z: float, n_bins: int | None = None) -> torch.Tensor:
    """(B, M, N) bool: the points the select kernel's depth-bin prefilter
    hands to its exact test, computed with the kernel's float32 arithmetic
    step for step (a mirror for tests; the kernel never calls it).

    Per row: ``n_bins`` (default ``depth_bins(N)``) equal bins over the
    finite depths' [lo, hi], or one bin when there is no finite depth or
    the range is under ``n_bins * 2**-21 * max(|lo|, |hi|)``; bin(x) =
    trunc(clamp((x - lo) * inv_w, 0, top)) with NaN to 0. A section's
    candidates are the finite points in bins bin(cz - dz) - 1 ..
    bin(cz + dz) + 1, clamped to the bins.
    """
    z = z_points.to(torch.float32)
    nb = depth_bins(z.shape[1]) if n_bins is None else int(n_bins)
    finite = torch.isfinite(z)
    inf = torch.tensor(float("inf"))
    lo = torch.where(finite, z, inf).amin(dim=1)
    hi = torch.where(finite, z, -inf).amax(dim=1)
    lo, hi = (torch.where(lo <= hi, x, torch.zeros_like(x)) for x in (lo, hi))
    span = hi - lo
    inv_w = torch.tensor(float(nb)) / span
    wide = (span > torch.maximum(lo.abs(), hi.abs()) * np.float32(nb * 2.0 ** -21)) \
        & torch.isfinite(inv_w)
    inv_w = torch.where(wide, inv_w, torch.zeros_like(inv_w))
    last = torch.where(wide, nb - 1, 0)
    lo, inv_w, last = lo[:, None], inv_w[:, None], last[:, None]

    def bin_of(x):
        t = (x - lo) * inv_w
        t = torch.where(torch.isnan(t), torch.zeros_like(t), t)
        return torch.minimum(t.clamp(min=0.0), last.float()).to(torch.int32)

    dz = torch.tensor(dis_z, dtype=torch.float32)
    zr = z_ref.to(torch.float32)
    bin_lo = (bin_of(zr - dz) - 1).clamp(min=0)
    bin_hi = torch.minimum(bin_of(zr + dz) + 1, last)
    pbin = bin_of(z)[:, None, :]
    return finite[:, None, :] & (pbin >= bin_lo[..., None]) & (pbin <= bin_hi[..., None])


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
