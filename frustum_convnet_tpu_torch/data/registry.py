"""Provider registry: maps DATA.FILE names to runtime dataset classes.

Replaces the reference's dynamic import of the provider module
(reference `train/train_net_det.py:250-252` via
`utils/utils.py:12-25`); reference yaml file paths resolve through
`configs.config.DATA_FILE_ALIASES`.
"""

from __future__ import annotations


def get_provider_class(cfg):
    name = cfg.DATA.FILE
    if name == "provider_sample":
        from frustum_convnet_tpu_torch.data.provider import FrustumProvider
        return FrustumProvider
    if name == "provider_sample_refine":
        from frustum_convnet_tpu_torch.data.provider_refine import FrustumRefineProvider
        return FrustumRefineProvider
    if name == "provider_sample_sunrgbd":
        from frustum_convnet_tpu_torch.data.provider_sunrgbd import FrustumSunrgbdProvider
        return FrustumSunrgbdProvider
    raise KeyError(f"Unknown provider '{name}'")
