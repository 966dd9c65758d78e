"""Static model specifications for the FrustumConvNet family.

A spec captures everything the flax module needs at trace time: scale count,
per-scale MLP widths and sample counts, encoder/decoder channel plan, box
codec sizes, and the section-ladder geometry. Two stock specs reproduce the
reference architectures:

* ``det_base``       — 4-scale KITTI model (reference `models/det_base.py:107-258`)
* ``det_base_sunrgbd`` — 5-scale SUN-RGBD model
  (reference `models/det_base_sunrgbd.py:107-280`)

The reference hardcodes each variant as a separate file; here one generic
module is parameterized by the spec, so new ladders are a config change.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from frustum_convnet_tpu_torch.data.dataset_info import DATASET_INFO


@dataclasses.dataclass(frozen=True)
class DetModelSpec:
    name: str
    # per-scale grouping + pointnet
    strides: Tuple[float, ...]
    height_half: Tuple[float, ...]  # depth half-window per scale
    nsamples: Tuple[int, ...]  # grouped points per section per scale
    mlps: Tuple[Tuple[int, int, int], ...]
    # 1D conv encoder-decoder
    block_channels: Tuple[int, ...]  # channels of block1..blockN
    deconv_channels: int  # per-deconv output channels
    # heads / codec
    num_classes: int  # fg/bg (2)
    num_vec: int  # one-hot category vector length
    num_bins: int  # heading bins
    num_sizes: int  # size templates
    mean_sizes: Tuple[Tuple[float, float, float], ...]  # (num_sizes, 3) l,w,h
    # data geometry
    max_depth: float
    num_points: int  # padded points per frustum (N)
    extra_feat_dim: int  # channels beyond xyz (0 or e.g. 1 intensity / 3 rgb)
    use_extra_feature: bool  # feed extra channels into the pointnets
    # refine stage: fixed ladder span (meters) instead of max_depth; None for
    # stage-1 providers whose ladder spans [0, max_depth)
    ref_span: float | None = None

    @property
    def num_scales(self) -> int:
        return len(self.strides)

    @property
    def num_refs(self) -> Tuple[int, ...]:
        """Sections per scale: ceil(span / stride) like the provider's
        ``arange(0, span, stride)`` grid (`datasets/provider_sample.py:296`)."""
        span = self.ref_span if self.ref_span is not None else self.max_depth
        return tuple(int(np.ceil(span / s - 1e-9)) for s in self.strides)

    @property
    def num_out(self) -> int:
        """Output sections = scale-2 sections (the encoder's stride-2 level)."""
        return self.num_refs[1]

    @property
    def reg_size(self) -> int:
        return 3 + self.num_bins * 2 + self.num_sizes * 4

    @property
    def mean_size_array(self) -> np.ndarray:
        return np.asarray(self.mean_sizes, dtype=np.float32)

    @property
    def head_channels(self) -> int:
        # deconv concat from blocks 2..N
        return self.deconv_channels * (len(self.block_channels) - 1)


def kitti_spec(cfg) -> DetModelSpec:
    info = DATASET_INFO[cfg.DATA.DATASET_NAME]
    extra = cfg.DATA.EXTRA_FEAT_DIM if cfg.DATA.WITH_EXTRA_FEAT else 0
    is_refine = cfg.DATA.FILE == "provider_sample_refine"
    return DetModelSpec(
        ref_span=float(cfg.DATA.REFINE_MAX_SPAN) if is_refine else None,
        name="det_base",
        strides=tuple(cfg.DATA.STRIDE),
        height_half=tuple(cfg.DATA.HEIGHT_HALF),
        nsamples=(32, 64, 64, 128),
        mlps=((64, 64, 128), (64, 64, 128), (128, 128, 256), (256, 256, 512)),
        block_channels=(128, 128, 256, 512),
        deconv_channels=256,
        num_classes=cfg.MODEL.NUM_CLASSES,
        num_vec=len(info.CLASSES),
        num_bins=cfg.DATA.NUM_HEADING_BIN,
        num_sizes=len(info.CLASSES),
        mean_sizes=tuple(tuple(r) for r in info.MEAN_SIZE_ARRAY.tolist()),
        max_depth=float(cfg.DATA.MAX_DEPTH),
        num_points=cfg.DATA.NUM_SAMPLES,
        extra_feat_dim=extra,
        use_extra_feature=extra > 0,
    )


def sunrgbd_spec(cfg) -> DetModelSpec:
    info = DATASET_INFO[cfg.DATA.DATASET_NAME]
    extra = cfg.DATA.EXTRA_FEAT_DIM if cfg.DATA.WITH_EXTRA_FEAT else 0
    return DetModelSpec(
        name="det_base_sunrgbd",
        strides=tuple(cfg.DATA.STRIDE),
        height_half=tuple(cfg.DATA.HEIGHT_HALF),
        nsamples=(128, 128, 256, 256, 256),
        mlps=(
            (64, 64, 128),
            (64, 64, 128),
            (128, 128, 256),
            (256, 256, 512),
            (256, 256, 512),
        ),
        block_channels=(64, 128, 256, 512, 512),
        deconv_channels=256,
        num_classes=cfg.MODEL.NUM_CLASSES,
        num_vec=len(info.CLASSES),
        num_bins=cfg.DATA.NUM_HEADING_BIN,
        num_sizes=len(info.CLASSES),
        mean_sizes=tuple(tuple(r) for r in info.MEAN_SIZE_ARRAY.tolist()),
        max_depth=float(cfg.DATA.MAX_DEPTH),
        num_points=cfg.DATA.NUM_SAMPLES,
        extra_feat_dim=extra,
        # the 5-scale reference model always runs xyz-only pointnets
        # (`det_base_sunrgbd.py:114-127` passes use_feature=False)
        use_extra_feature=False,
    )
