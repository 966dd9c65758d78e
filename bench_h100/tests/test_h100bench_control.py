"""The control on the card: the reference computed in TF32, the precision
next below the configurations' float32 with TF32 off, put in the program's
place, reads ``correct`` false against every cell's limits, while the
program on the same inputs reads true. At a size a test run holds: the
published widths, fewer frustums and steps than a cell's.

    python3 -m pytest -q bench_h100/tests/test_h100bench_control.py

``python3 -m bench_h100.control`` reads the same numbers at a cell's own
size over many seeds; the limits were set from its readings."""

import argparse

import pytest

from bench_h100 import common, control, run
from bench_h100.tests import tiny

ORIGINAL = common.load_json


def load_json(*parts):
    """A cell's files with the traffic at its job module's ``SMALL``."""
    d = ORIGINAL(*parts)
    return tiny.sized(d, run.job_module(d).SMALL) if parts[0] == "traffic" else d


@pytest.mark.parametrize("cell", [c["name"] for c in
                                  common.load_json("..", "BENCHMARK.json")["workloads"]])
def test_the_control_fails_and_the_program_passes(cuda, monkeypatch, cell):
    monkeypatch.setattr(common, "load_json", load_json)
    out = control.readings(argparse.Namespace(workload=cell), 2**31 + 101, True, cuda)
    limits = common.load_json("limits", f"{cell}.json")
    assert all(out["program"][k] <= v for k, v in limits.items()), out
    assert any(out["control"][k] > v for k, v in limits.items()), out
