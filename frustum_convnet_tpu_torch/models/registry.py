"""Model registry: maps config names (or reference file-path aliases) to
model-spec factories.

Replaces the reference's dynamic-import-by-file-path mechanism
(reference `utils/utils.py:12-25`, used at
`train/train_net_det.py:292-294`) with an explicit registry; the reference's
yaml values still work via `configs.config.MODEL_FILE_ALIASES`.
"""

from __future__ import annotations

from frustum_convnet_tpu_torch.models.spec import kitti_spec, sunrgbd_spec

MODEL_REGISTRY = {
    "det_base": kitti_spec,
    "det_base_sunrgbd": sunrgbd_spec,
}


def get_model_spec(cfg):
    name = cfg.MODEL.FILE
    if name not in MODEL_REGISTRY:
        raise KeyError(f"Unknown model '{name}'. Known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](cfg)
