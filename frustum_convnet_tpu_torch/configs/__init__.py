"""Config entry of the port: the config tree, the model spec, and torch
dtype resolution.

``config`` and ``attrdict`` hold the key set, yaml merge and CLI overrides,
``models.registry.get_model_spec`` maps a config to its ``DetModelSpec``, and
``dtypes`` resolves the ``cfg.TPU`` dtype keys to torch dtypes.
"""

from frustum_convnet_tpu_torch.configs.config import (
    assert_and_infer_cfg,
    cfg,
    get_default_cfg,
    merge_cfg_from_file,
    merge_cfg_from_list,
    reset_cfg,
)
from frustum_convnet_tpu_torch.configs.dtypes import (
    get_compute_dtype,
    get_points_upload_dtype,
    get_trunk_dtype,
)
from frustum_convnet_tpu_torch.models.registry import get_model_spec

__all__ = [
    "cfg",
    "assert_and_infer_cfg",
    "get_default_cfg",
    "merge_cfg_from_file",
    "merge_cfg_from_list",
    "reset_cfg",
    "get_model_spec",
    "get_compute_dtype",
    "get_trunk_dtype",
    "get_points_upload_dtype",
]
