"""Torch dtype resolution of the port's config: the counterpart of
``frustum_convnet_tpu/models/registry.py:27-51``.

``cfg.TPU.{COMPUTE,INFER,TRUNK}_DTYPE`` and ``cfg.TPU.INFER_POINTS_DTYPE``
resolved to torch dtypes. The port computes in float32 only so far; a
half-precision compute dtype raises instead of silently running float32, and
so does every training variant that is not ported yet
(:func:`check_train_supported`).
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _compute_dtype(name: str, key: str) -> torch.dtype:
    if name not in _DTYPES:
        raise KeyError(f"{key}={name!r}: expected one of {sorted(_DTYPES)}")
    if _DTYPES[name] != torch.float32:
        raise NotImplementedError(
            f"{key}={name!r}: the torch port computes in float32 only; "
            "half-precision compute is not ported yet")
    return torch.float32


def get_compute_dtype(cfg) -> torch.dtype:
    """``cfg.TPU.COMPUTE_DTYPE``, the training compute dtype (float32 only)."""
    return _compute_dtype(cfg.TPU.COMPUTE_DTYPE, "TPU.COMPUTE_DTYPE")


def get_infer_dtype(cfg) -> torch.dtype:
    """``cfg.TPU.INFER_DTYPE`` as a torch dtype (float32 only)."""
    return _compute_dtype(cfg.TPU.INFER_DTYPE, "TPU.INFER_DTYPE")


def get_trunk_dtype(cfg) -> torch.dtype | None:
    """``cfg.TPU.TRUNK_DTYPE`` ("" = None = follow the model dtype)."""
    name = cfg.TPU.TRUNK_DTYPE
    return _compute_dtype(name, "TPU.TRUNK_DTYPE") if name else None


def get_points_upload_dtype(cfg) -> torch.dtype:
    """``cfg.TPU.INFER_POINTS_DTYPE``: the host->device dtype of the point
    stream, decoded back to float32 on the device. float16 halves the
    dominant upload; float32 uploads as is."""
    name = cfg.TPU.INFER_POINTS_DTYPE
    if name not in ("float16", "float32"):
        raise ValueError(
            f"TPU.INFER_POINTS_DTYPE={name!r}: expected float16 or float32")
    return _DTYPES[name]


def check_train_supported(cfg) -> None:
    """Raise on the training variants the port does not have yet: ghost
    BatchNorm, analytic BatchNorm statistics, rematerialized PointNet MLPs
    and half-precision compute."""
    get_compute_dtype(cfg)
    get_trunk_dtype(cfg)
    for key, on in (("TPU.BN_GROUP_SIZE", cfg.TPU.BN_GROUP_SIZE > 0),
                    ("TPU.FAST_BN", cfg.TPU.FAST_BN),
                    ("TPU.FAST_BN_FIRST", cfg.TPU.FAST_BN_FIRST),
                    ("TPU.REMAT_POINTNET", cfg.TPU.REMAT_POINTNET)):
        if on:
            raise NotImplementedError(
                f"{key} is set: the torch port trains with global-batch "
                "BatchNorm and no rematerialization only; this variant is "
                "not ported yet")
