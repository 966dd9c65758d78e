"""A cell at a size the CPU runs in seconds: few frustums, small batches,
256 points a frustum; every width of the model stays as published. The
traffic's size is its job module's ``TINY``."""

import json

from bench_h100 import common, run

ORIGINAL = common.load_json


def sized(traffic: dict, overrides: dict) -> dict:
    """``traffic`` with ``overrides`` in place; their ``cfg`` merges key by
    key into the traffic's."""
    d = dict(traffic, **overrides)
    if "cfg" in overrides:
        d["cfg"] = {**traffic.get("cfg", {}), **overrides["cfg"]}
    return d


def load_json(*parts):
    d = ORIGINAL(*parts)
    if parts[0] == "traffic":
        d = sized(d, run.job_module(d).TINY)
    elif parts[0] == "configs":
        d = json.loads(json.dumps(d))
        d["cfg"]["DATA.NUM_SAMPLES"] = d["model"]["num_points"] = 256
    return d


def apply(monkeypatch) -> None:
    monkeypatch.setattr(common, "load_json", load_json)
