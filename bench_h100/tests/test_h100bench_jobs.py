"""A cell whose traffic names a job the harness has never seen is taken by
``run``, ``control``, ``tiny`` and the card control test's sizing through
the job module alone (``run``, ``TINY``, ``SMALL``, ``readings``): a stub
job, put in ``sys.modules`` as ``bench_h100.stub_job``, and a cell of it
patched into the files the harness loads. Nothing in the tree is written."""

import argparse
import sys
import types

import pytest
import torch

from bench_h100 import common, control, run
from bench_h100.tests import test_h100bench_control as control_test
from bench_h100.tests import tiny

CELL, TRAFFIC = "kitti_car.stub_mix", "stub_mix"
STUB_TRAFFIC = {"job": "stub_job", "frustums": 4096, "cfg": {"TEST.METHOD": "top"}}


def stub_module(seen: list) -> types.ModuleType:
    job = types.ModuleType("bench_h100.stub_job")
    job.TINY = {"frustums": 16, "cfg": {"TEST.BATCH_SIZE": 2}}
    job.SMALL = {"frustums": 256}

    def run_job(j):
        seen.append(j)
        return {"end_to_end": {"setup_s": 1.5}, "numbers": {"gap": 0.25},
                "attempted": j["traffic"]["frustums"], "failed": 0,
                "device": {"platform": "cpu", "kind": "cpu", "count": 1,
                           "memory_peak_bytes": 0},
                "ctx": {"job": "stub_job"}}

    def readings(j, control):
        seen.append(j)
        return {"program": {"gap": 0.25},
                **({"control": {"gap": 2.0}, "fault": {"gap": 3.0}} if control else {})}

    job.run, job.readings = run_job, readings
    return job


@pytest.fixture
def stub(monkeypatch):
    """The stub job in ``sys.modules`` and its cell in the files as
    ``common.load_json`` (and the loaders the tests wrap) read them; the
    jobs the stub was handed."""
    seen = []
    monkeypatch.setitem(sys.modules, "bench_h100.stub_job", stub_module(seen))
    original = common.load_json

    def load_json(*parts):
        if parts[0] == "traffic" and parts[1] == f"{TRAFFIC}.json":
            return dict(STUB_TRAFFIC)
        if parts[0] == "limits" and parts[1] == f"{CELL}.json":
            return {"gap": 1.0}
        d = original(*parts)
        if parts[-1] == "BENCHMARK.json":
            d = dict(d, workloads=d["workloads"] + [
                {"name": CELL, "config": "kitti_car", "traffic": TRAFFIC, "chips": 1,
                 "why": "a stub job"}])
        return d

    monkeypatch.setattr(common, "load_json", load_json)
    monkeypatch.setattr(tiny, "ORIGINAL", load_json)
    monkeypatch.setattr(control_test, "ORIGINAL", load_json)
    return seen


@pytest.mark.parametrize("trace", [0, 1])
def test_run_takes_the_job(stub, trace):
    args = argparse.Namespace(workload=CELL, seed=2**31 + 7, seconds=1, trace=trace)
    result = run.run_cell(args, device=torch.device("cpu"), log=lambda m: None)
    assert result["correct"] is True and result["attempted"] == 4096
    assert result["metrics"] == ({} if trace else {"setup_s": {"value": 1.5, "unit": "s"}})
    assert result["checks"] == {"gap": {"value": 0.25, "limit": 1.0}}
    (job,) = stub
    assert job["traffic"] == STUB_TRAFFIC and job["seed"] == 2**31 + 7
    assert job["trace"] is bool(trace) and job["config"]["cfg"]


def test_tiny_applies_the_jobs_tiny(stub):
    assert tiny.load_json("traffic", f"{TRAFFIC}.json") == {
        "job": "stub_job", "frustums": 16,
        "cfg": {"TEST.METHOD": "top", "TEST.BATCH_SIZE": 2}}


def test_the_control_tests_sizing_applies_the_jobs_small(stub):
    assert control_test.load_json("traffic", f"{TRAFFIC}.json") == dict(STUB_TRAFFIC,
                                                                         frustums=256)


def test_control_returns_the_jobs_readings(stub):
    out = control.readings(argparse.Namespace(workload=CELL), 11, True, torch.device("cpu"))
    assert out == {"seed": 11, "program": {"gap": 0.25}, "control": {"gap": 2.0},
                   "fault": {"gap": 3.0}}
    assert stub[0]["traffic"] == STUB_TRAFFIC
    assert control.readings(argparse.Namespace(workload=CELL), 12, False,
                            torch.device("cpu")) == {"seed": 12, "program": {"gap": 0.25}}


def test_controls_summary_takes_every_kind_the_job_reads(stub, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda device: None)
    assert control.main(["--workload", CELL, "--seeds", "1,2,3", "--control", "2"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == ('{"workload": "kitti_car.stub_mix", "program_max": {"gap": 0.25}, '
                    '"control_min": {"gap": 2.0}, "fault_min": {"gap": 3.0}}')
