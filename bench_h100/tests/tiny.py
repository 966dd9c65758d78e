"""A cell at a size the CPU runs in seconds: few frustums, small batches,
256 points a frustum; every width of the model stays as published."""

import json

from bench_h100 import common, serve

ORIGINAL = common.load_json


def load_json(*parts):
    d = ORIGINAL(*parts)
    if parts[0] == "traffic" and d["job"] == "serve":
        d = dict(d, frustums=64, warm_calls=1,
                 cfg={**d.get("cfg", {}), "TEST.BATCH_SIZE": 8, "TPU.INFER_GROUP": 2})
    elif parts[0] == "traffic":
        d = dict(d, batch=4, steps_per_epoch=6, frustums=24, trace_steps=[2, 4], warm_calls=0,
                 cfg={**d.get("cfg", {}), "TRAIN.BATCH_SIZE": 4, "disp": 3})
    elif parts[0] == "configs":
        d = json.loads(json.dumps(d))
        d["cfg"]["DATA.NUM_SAMPLES"] = d["model"]["num_points"] = 256
    return d


def apply(monkeypatch) -> None:
    monkeypatch.setattr(common, "load_json", load_json)
    monkeypatch.setattr(serve, "FIT_FRUSTUMS", 32)
