"""What the serving and training jobs share: files, the program's config and
model, weights, inputs and the device's numbers."""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

from bench_h100.frozen import items as frozen_items
from bench_h100.frozen import synthetic
from bench_h100.reference.spec import ModelSpec

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def program_cfg(config: dict, overrides: dict):
    """The program's config tree: its defaults, then every key of the
    configuration file's ``cfg`` and the traffic's ``cfg`` (dotted keys)."""
    from frustum_convnet_tpu_torch import configs

    cfg = configs.get_default_cfg()
    pairs = []
    for key, value in list(config["cfg"].items()) + list(overrides.items()):
        pairs += [key, value]
    configs.merge_cfg_from_list(pairs, cfg)
    configs.assert_and_infer_cfg(cfg)
    return cfg


def check_spec(program_spec, spec: ModelSpec) -> None:
    """The program builds the model the configuration file states."""
    for name in ("strides", "height_half", "nsamples", "mlps", "block_channels",
                 "deconv_channels", "num_classes", "num_vec", "num_bins", "num_sizes",
                 "max_depth", "num_points", "num_refs", "num_out", "reg_size"):
        got, want = getattr(program_spec, name), getattr(spec, name)
        if np.asarray(got, dtype=object).tolist() != np.asarray(want, dtype=object).tolist():
            raise ValueError(f"the program's {name} is {got}, the configuration states {want}")
    if not np.allclose(np.asarray(program_spec.mean_sizes), np.asarray(spec.mean_sizes)):
        raise ValueError("the program's size templates differ from the configuration's")


def program_model(spec_p, params: dict, device, dtype=torch.float32):
    """The program's detector holding a copy of ``params``."""
    from frustum_convnet_tpu_torch.models.net import FrustumConvNet

    model = FrustumConvNet(spec_p, dtype=dtype).to(device)
    state = model.state_dict()
    missing = set(state) - set(params) - {k for k in state if k.endswith("num_batches_tracked")}
    if missing:
        raise ValueError(f"no weights for {sorted(missing)[:4]}")
    model.load_state_dict({k: params[k].clone() if k in params else state[k]
                           for k in state}, strict=True)
    return model


def frustum_records(config: dict, traffic: dict, rng, labeled: bool) -> dict:
    return synthetic.make_frustums(rng, traffic["frustums"], tuple(config["classes"]),
                                   traffic.get("objects_per_frame", 4), labeled=labeled)


def make_items(rec: dict, spec: ModelSpec, rng, labeled: bool = False) -> list:
    """The provider's items of every record, drawing from ``rng`` in order;
    training items take the provider's flip and shift."""
    return frozen_items.make_items(rec, synthetic.P2, spec.num_points, spec.strides,
                                   spec.max_depth, rng, labeled=labeled,
                                   random_flip=labeled, random_shift=labeled)


def device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(peak)}


def quiet_logger() -> logging.Logger:
    """The logger the program's drivers write to: discarded."""
    logger = logging.getLogger("bench_h100.program")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger
