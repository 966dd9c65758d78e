"""Each cell's set-up, window and check on the CPU at a tiny size, with the
plain grouping in place of kernel 1: the last line's keys and metrics, and
the reference against the program."""

import argparse
import json
import math

import pytest
import torch

from bench_h100 import common, run
from bench_h100.tests import tiny

BENCH = common.load_json("..", "BENCHMARK.json")
CELLS = [c["name"] for c in BENCH["workloads"]]


def run_tiny(monkeypatch, cell: str, trace: int, seed: int = 2**31 + 11) -> dict:
    tiny.apply(monkeypatch)
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.5, trace=trace)
    return run.run_cell(args, device=torch.device("cpu"), log=lambda m: None)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(monkeypatch, cell, trace):
    result = run_tiny(monkeypatch, cell, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + ["checks"]
    json.dumps(result)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in BENCH[kind] if run.applies(m, cell)}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
        assert all(m["value"] > 0 for m in result["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    limits = common.load_json("limits", f"{cell}.json")
    assert set(result["checks"]) == set(limits)
    for c in result["checks"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]


def test_the_same_seed_makes_the_same_inputs(monkeypatch):
    tiny.apply(monkeypatch)
    from bench_h100 import serve

    args = argparse.Namespace(workload=CELLS[0], seed=7, seconds=0, trace=0)
    got = []
    for _ in range(2):
        _, _, job = run.make_job(args, torch.device("cpu"), log=lambda m: None)
        s = serve.prepare(job)
        got.append((s["inputs"], {k: v.clone() for k, v in s["params"].items()}))
    (a, pa), (b, pb) = got
    assert all((a[k] == b[k]).all() for k in a)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
