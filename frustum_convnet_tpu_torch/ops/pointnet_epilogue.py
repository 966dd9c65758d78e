"""The PointNet eval epilogue: BatchNorm with its running statistics, ReLU,
the empty-section mask and the slot max-pool, one CUDA pass after a GEMM.

``csrc/pointnet_epilogue.cu`` replaces no TPU kernel: the JAX package
leaves this epilogue to XLA. Its two entry points, each
with its plain PyTorch version (the sequence ``models/net.py`` runs in
eval, called from there) and a launch counter (``<wrapper>.launches``):

* ``bn_relu_cuda_(y, bn)``: in place on a (..., C) float32 GEMM output,
  every element ``relu((y - mean) * inv + bias)``: every PointNet layer but
  the last of a scale (``bn_relu_plain``);
* ``bn_relu_mask_maxpool_cuda(y, cnt, bn)``: (B, M, K, C) -> (B, M, C), the
  same per element, then 0 for a section whose ``cnt`` is 0, else the max
  over the K slots: the last layer of a scale
  (``bn_relu_mask_maxpool_plain``).

``bn`` is the layer's eval BatchNorm: the kernels read its running mean and
variance, weight, bias and epsilon, and work out ``inv = (1 / sqrt(var +
eps)) * weight`` themselves. They round each step on its own, in the plain
order, so the two agree bit for bit (NaN where the plain version has NaN).
Neither has a backward: ``models/net.py`` launches them only with grad
mode off.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from frustum_convnet_tpu_torch.ops._build import load_library

KERNEL_SOURCE = "frustum_convnet_tpu_torch/csrc/pointnet_epilogue.cu"
MAX_POOL_CHANNELS = 1024  # C/4 threads a section, at most one 256-thread block
_LIB: list = []  # the loaded library, once its argument types are set


def bn_relu_plain(y: torch.Tensor, bn) -> torch.Tensor:
    """The model's eval BatchNorm and ReLU over the last axis of ``y``."""
    from frustum_convnet_tpu_torch.models import net  # net imports this module

    return F.relu(net._bn(y, bn, -1))


def bn_relu_mask_maxpool_plain(y: torch.Tensor, cnt: torch.Tensor, bn) -> torch.Tensor:
    """``bn_relu_plain``, then the model's eval mask and pool
    (``net.pool_sections``): (B, M, K, C) -> (B, M, C)."""
    from frustum_convnet_tpu_torch.models import net

    return net.pool_sections(bn_relu_plain(y, bn), cnt, False)


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = load_library("pointnet_epilogue")
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.fcn_bn_relu.argtypes = [ptr, ptr, ptr, ptr, ptr, f32, i64, i32, i32, ptr]
        lib.fcn_bn_relu.restype = i32
        lib.fcn_bn_relu_mask_maxpool.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, f32, ptr, i64, i32, i32, i32, ptr]
        lib.fcn_bn_relu_mask_maxpool.restype = i32
        lib.fcn_epilogue_error_string.argtypes = [i32]
        lib.fcn_epilogue_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _check(y: torch.Tensor, bn, rank: int | None, name: str) -> tuple:
    """Device, dtype, rank, contiguity, alignment and no gradient of ``y``,
    and ``bn``'s (C,) statistics and affine parameters; returns the data
    pointers of its mean, variance, weight and bias."""
    if y.device.type != "cuda" or y.dtype != torch.float32:
        raise ValueError(f"{name}: y must be float32 on a CUDA device, got "
                         f"{y.dtype} on {y.device}")
    if (rank is not None and y.dim() != rank) or y.dim() < 1:
        raise ValueError(f"{name}: y must have rank {rank or '>= 1'}, got {tuple(y.shape)}")
    c = y.shape[-1]
    if c % 4 or not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError(f"{name}: y must be contiguous and 16-byte aligned with "
                         f"a channel count divisible by 4, got {tuple(y.shape)}")
    if y.requires_grad:
        raise ValueError(f"{name}: y requires grad, but the kernel has no backward")
    params = (bn.running_mean, bn.running_var, bn.weight, bn.bias)
    for p in params:
        if (p is None or p.device != y.device or p.dtype != torch.float32
                or p.shape != (c,) or not p.is_contiguous() or p.data_ptr() % 16):
            got = "None" if p is None else f"{tuple(p.shape)} {p.dtype} on {p.device}"
            raise ValueError(f"{name}: the BatchNorm's running statistics, weight and "
                             f"bias must be contiguous ({c},) float32 on {y.device}, "
                             f"got {got}")
    return tuple(p.data_ptr() for p in params)


def _launch(lib, fn, name: str, y: torch.Tensor, *args) -> None:
    index = y.device.index if y.device.index is not None else torch.cuda.current_device()
    err = fn(*args, index, torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.fcn_epilogue_error_string(err).decode())


def bn_relu_cuda_(y: torch.Tensor, bn) -> torch.Tensor:
    """``bn_relu_plain(y, bn)`` written over ``y`` (contiguous (..., C)
    float32 on the card, C divisible by 4); returns ``y``."""
    stats = _check(y, bn, None, "bn_relu")
    if y.numel():
        lib = _lib()
        _launch(lib, lib.fcn_bn_relu, "bn_relu", y, y.data_ptr(), *stats, bn.eps,
                y.numel(), y.shape[-1])
        bn_relu_cuda_.launches += 1
    return y


bn_relu_cuda_.launches = 0  # kernel launches since the last reset


def bn_relu_mask_maxpool_cuda(y: torch.Tensor, cnt: torch.Tensor, bn) -> torch.Tensor:
    """``bn_relu_mask_maxpool_plain``: y (B, M, K, C) float32 on the card,
    contiguous, C divisible by 4 and at most 1024, cnt (B, M) int32 ->
    (B, M, C) float32."""
    stats = _check(y, bn, 4, "bn_relu_mask_maxpool")
    b, m, k, c = y.shape
    if (cnt.device != y.device or cnt.dtype != torch.int32 or cnt.shape != (b, m)
            or not cnt.is_contiguous()):
        raise ValueError(f"bn_relu_mask_maxpool: cnt must be a contiguous (B={b}, "
                         f"M={m}) int32 tensor on {y.device}, got {tuple(cnt.shape)} "
                         f"{cnt.dtype} on {cnt.device}")
    if c > MAX_POOL_CHANNELS or k < 1:
        raise ValueError(f"bn_relu_mask_maxpool: C={c} above {MAX_POOL_CHANNELS} "
                         f"or K={k} below 1")
    out = torch.empty((b, m, c), dtype=torch.float32, device=y.device)
    if out.numel():
        lib = _lib()
        _launch(lib, lib.fcn_bn_relu_mask_maxpool, "bn_relu_mask_maxpool", y,
                y.data_ptr(), cnt.data_ptr(), *stats, bn.eps, out.data_ptr(), b * m, k, c)
        bn_relu_mask_maxpool_cuda.launches += 1
    return out


bn_relu_mask_maxpool_cuda.launches = 0
