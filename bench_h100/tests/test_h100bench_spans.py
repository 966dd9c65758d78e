"""``bench_h100/spans.py``: the device's idle time charged to the program's
spans, on a hand-made trace and on each cell's tiny CPU run."""

import pytest
import torch

from bench_h100 import run, spans, trace
from bench_h100.tests import tiny
from bench_h100.tests.test_h100bench_harness import BENCH, CELLS


def _x(name, t0, t1, cat="user_annotation", tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": t0, "dur": t1 - t0, "pid": 7,
            "tid": tid}


def _events(root=True):
    """A stretch of 100 us: the device busy over [10, 20], [30, 60] + [55, 70]
    (overlapping) and [90, 95], so idle over [0, 10], [20, 30], [70, 90] and
    [95, 100]: 45 us."""
    ev = [_x(trace.WINDOW_SPAN, 0, 100),
          _x("k1", 10, 20, "kernel", 8), _x("k2", 30, 60, "kernel", 8),
          _x("memcpy", 55, 70, "gpu_memcpy", 9), _x("k3", 90, 95, "kernel", 8),
          _x("serve.upload", 5, 25), _x("aten::copy_", 6, 9, "cpu_op"),
          _x("cudaMemcpyAsync", 21, 24, "cuda_runtime"),
          _x("serve.dispatch", 25, 35),
          _x("serve.loader_wait", 65, 80), _x("serve.postprocess", 80, 92),
          _x("serve.fetch", 85, 88),
          _x("serve.upload", 0, 100, tid=2),  # another thread: not the loop's
          _x("gpu_serve.upload", 5, 25, "gpu_user_annotation", 8)]
    if root:
        ev.append(_x("serve.call", 0, 100))
    return ev


def test_idle_is_charged_by_exact_overlap_to_the_innermost_program_span():
    idle = spans.idle_by_span({"traceEvents": _events()})
    want = {"serve.upload": 10, "serve.dispatch": 5, "serve.loader_wait": 10,
            "serve.postprocess": 7, "serve.fetch": 3, "serve.call": 10, "none": 0}
    assert idle.keys() == want.keys()
    for k, v in want.items():
        assert idle[k] == pytest.approx(v * 1e-6, abs=1e-15), k
    acc = spans.account(idle, 100e-6)
    assert acc["unattributed_pct"] == pytest.approx(100 * 10 / 45)
    assert acc["idle_pct"]["serve.upload"] == pytest.approx(10.0)


def test_idle_under_no_span_is_none_and_the_charges_sum_to_the_idle():
    events = _events(root=False)
    idle = spans.idle_by_span(events)
    summary = trace.summarize(events, 100e-6)
    assert idle["none"] == pytest.approx(10e-6)  # [0, 5] and [95, 100]
    assert "serve.call" not in idle
    assert sum(idle.values()) == pytest.approx(summary.window_s - summary.busy_s)
    assert summary.busy_s == pytest.approx(55e-6)
    assert spans.trace_totals(events)["serve.upload"] == {"n": 1, "s": pytest.approx(20e-6)}


def test_a_trace_without_a_stretch_charges_nothing():
    assert spans.idle_by_span([_x("serve.call", 0, 10)]) == {}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_with_its_idle_charged(monkeypatch, cell, capsys):
    """The tiny CPU run of each cell: the result line of ``--trace 1``, plus
    the charges, which on the CPU (no device interval) sum to the whole
    stretch and fall mostly under the program's spans."""
    tiny.apply(monkeypatch)
    result = spans.main(["--workload", cell, "--seed", str(2**31 + 5), "--seconds", "0.5"],
                        device=torch.device("cpu"), log=lambda m: None)
    assert result["correct"] is True
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device",
                            "breakdown", "checks", "spans"]
    assert set(result["metrics"]) <= {m["name"] for m in BENCH["per_layer"]
                                      if run.applies(m, cell)}
    idle, window_s = result["spans"]["idle_s"], result["device"]["window_s"]
    assert result["device"]["busy_s"] == 0
    assert sum(idle.values()) == pytest.approx(window_s, rel=0.05)
    root = "serve.call" if "serve" in cell else "train.epoch"
    steps = {"train.step", "train.upload"} if root == "train.epoch" else {
        "serve.upload", "serve.dispatch", "serve.postprocess", "serve.fetch"}
    assert steps <= set(idle) and steps <= set(result["spans"]["trace_totals"])
    if root == "serve.call":
        assert result["spans"]["trace_totals"]["serve.call"]["n"] == 1
    assert capsys.readouterr().out.strip().startswith("{")
