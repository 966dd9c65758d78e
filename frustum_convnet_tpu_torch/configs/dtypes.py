"""Torch dtype resolution of the port's config: the counterpart of
``frustum_convnet_tpu/models/registry.py:27-51``.

``cfg.TPU.{COMPUTE,INFER,TRUNK}_DTYPE`` and ``cfg.TPU.INFER_POINTS_DTYPE``
resolved to torch dtypes. The compute dtypes are float32, bfloat16 and
float16; parameters, BatchNorm statistics and optimizer state stay float32
in every mode (``models/net.FrustumConvNet``).
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _resolve(name: str, key: str) -> torch.dtype:
    if name not in _DTYPES:
        raise KeyError(f"{key}={name!r}: expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def get_compute_dtype(cfg, train: bool) -> torch.dtype:
    """The model's computation dtype: ``cfg.TPU.COMPUTE_DTYPE`` for
    training, ``cfg.TPU.INFER_DTYPE`` for the serving drivers."""
    if train:
        return _resolve(cfg.TPU.COMPUTE_DTYPE, "TPU.COMPUTE_DTYPE")
    return _resolve(cfg.TPU.INFER_DTYPE, "TPU.INFER_DTYPE")


def get_trunk_dtype(cfg) -> torch.dtype | None:
    """``cfg.TPU.TRUNK_DTYPE``: the conv trunk's and the heads' own dtype
    ("" = None = follow the compute dtype)."""
    name = cfg.TPU.TRUNK_DTYPE
    return _resolve(name, "TPU.TRUNK_DTYPE") if name else None


def get_points_upload_dtype(cfg) -> torch.dtype:
    """``cfg.TPU.INFER_POINTS_DTYPE``: the host->device dtype of the point
    stream, decoded back to float32 on the device. float16 halves the
    dominant upload; float32 uploads as is."""
    name = cfg.TPU.INFER_POINTS_DTYPE
    if name not in ("float16", "float32"):
        raise ValueError(
            f"TPU.INFER_POINTS_DTYPE={name!r}: expected float16 or float32")
    return _DTYPES[name]
