"""The SUN-RGBD serving job: its frozen items against the program's own
provider, and its timed path broken underneath reading ``correct`` false
(the harness's look for a chip skipped: CPU, tiny size)."""

import argparse

import numpy as np
import pytest
import torch

from bench_h100 import common, run, serve_sunrgbd
from bench_h100.frozen import sunrgbd_items, sunrgbd_synthetic
from bench_h100.reference import serve as ref_serve
from bench_h100.reference import serve_sunrgbd as ref_sun
from bench_h100.tests import tiny
from frustum_convnet_tpu_torch.data.dataset_info import DATASET_INFO
from frustum_convnet_tpu_torch.data.provider_sunrgbd import FrustumSunrgbdProvider
from frustum_convnet_tpu_torch.engine import test_sunrgbd as driver

CELL = "sunrgbd.serve_g8b32"
STRIDES = (0.1, 0.2, 0.4, 0.8, 1.6)
KEYS = ("id", "box2d", "input", "type", "box2d_prob", "frustum_angle", "calib_K", "calib_R")


def provider(rec, npoints: int):
    """The program's provider over ``rec``, as the SUN-RGBD driver builds it
    on a detection file."""
    p = object.__new__(FrustumSunrgbdProvider)
    p.npoints, p.one_hot, p.rotate_to_center, p.with_extra_feat = npoints, True, True, False
    p.random_flip = p.random_shift = False
    p.from_rgb_detection = True
    p.category_info = DATASET_INFO["SUNRGBD"]
    p.strides, p.max_depth = list(STRIDES), 8.0
    p.data = {k: rec[k] for k in KEYS}
    p._points_key = "input"
    return p


@pytest.mark.parametrize("npoints", [2048, 256])
def test_items_equal_the_providers_bit_for_bit(npoints):
    rec = sunrgbd_synthetic.make_frustums(np.random.default_rng(11), 48)
    assert min(len(p) for p in rec["input"]) < 2048  # some drawn with replacement
    got = sunrgbd_items.make_items(rec, npoints, STRIDES, 8.0, np.random.default_rng(5))
    prov, rng = provider(rec, npoints), np.random.default_rng(5)
    for i, item in enumerate(got):
        want = prov.__getitem__(i, rng)
        assert set(item) == set(want)
        for k, v in want.items():
            pairs = zip(v, item[k]) if k == "refs" else [(v, item[k])]
            for a, b in pairs:
                a, b = np.asarray(a), np.asarray(b)
                assert a.dtype == b.dtype and a.shape == b.shape, (i, k)
                assert np.array_equal(a, b), (i, k)


def test_frustums_hold_their_objects():
    rec = sunrgbd_synthetic.make_frustums(np.random.default_rng(3), 64)
    assert len(rec["id"]) == 64 and set(rec["type"]) <= set(sunrgbd_synthetic.CLASSES)
    assert all(0 < len(p) <= 2048 and p.dtype == np.float32 for p in rec["input"])
    assert all(0.6 <= p < 0.95 for p in rec["box2d_prob"])
    items = sunrgbd_items.make_items(rec, 256, STRIDES, 8.0, np.random.default_rng(3))
    fg = [sunrgbd_items.foreground(rec, i, it["refs"][1]).sum() for i, it in enumerate(items)]
    assert min(fg) >= 1 and [len(r) for r in items[0]["refs"]] == [80, 40, 20, 10, 5]


def altered_answer(monkeypatch):
    """Each served box lies 0.1 m deeper than the model put it."""
    original = driver.label_format_batch

    def moved(*args, **kwargs):
        boxes = original(*args, **kwargs)
        boxes[:, 2] += 0.1
        return boxes

    monkeypatch.setattr(driver, "label_format_batch", moved)


def half_served(monkeypatch):
    """Only the first half of each batch's frustums is served."""
    original = driver.postprocess_packed_sun

    def half(packed, cnt, batch, *args, **kwargs):
        return original(packed, cnt, dict(batch, _real=int(batch["_real"]) // 2), *args,
                        **kwargs)

    monkeypatch.setattr(driver, "postprocess_packed_sun", half)


def no_pipeline_stats(monkeypatch):
    """A driver from before the group pipeline: no spans, no fetch_waited."""
    original = driver.run_test_sunrgbd

    def plain(*args, **kwargs):
        det, stats = original(*args, **kwargs)
        return det, {k: v for k, v in stats.items() if k not in ("spans", "fetch_waited")}

    monkeypatch.setattr(driver, "run_test_sunrgbd", plain)


def _run(monkeypatch, fault):
    tiny.apply(monkeypatch)
    fault(monkeypatch)
    args = argparse.Namespace(workload=CELL, seed=2**31 + 23, seconds=0.1, trace=0)
    return run.run_cell(args, device=torch.device("cpu"), log=lambda m: None)


@pytest.mark.parametrize("fault", [altered_answer, half_served],
                         ids=["altered-answer", "half-batch"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    result = _run(monkeypatch, fault)
    assert result["correct"] is False, result["checks"]


def test_a_driver_without_the_pipeline_fails_at_its_first_call(monkeypatch):
    with pytest.raises(RuntimeError, match="no spans or no fetch_waited"):
        _run(monkeypatch, no_pipeline_stats)
    assert serve_sunrgbd.CALLS == []


def tied_table(min_size_0: float = 0.5) -> dict:
    """A 'top' table of 2 frustums of 3 sections: frustum 0's first two
    sections tie at a float32 probability of 1.0, frustum 1's second leads
    by a logit; every best box is an answer, the runner-ups are not."""
    key = torch.tensor([[ref_sun.SATURATED, ref_sun.SATURATED, 0.0], [1.0, 3.0, 2.0]],
                       dtype=torch.float64)
    values = torch.arange(2 * 3 * 4 * 8, dtype=torch.float64).reshape(2, 3, 4, 8) + 1.0
    ok = torch.zeros(2, 3, 4, dtype=torch.bool)
    ok[..., 0] = True
    min_size = torch.tensor([[min_size_0, 0.4, 0.3], [0.5, 0.5, 0.5]], dtype=torch.float64)
    return {"margin": key.clone(), "key": key, "values": values, "ok": ok,
            "min_size": min_size}


def served(table: dict, sections) -> tuple:
    """``served_arrays``' form of the best boxes of (frustum, section) pairs."""
    f = np.asarray([p[0] for p in sections], np.int64)
    s = np.asarray([p[1] for p in sections], np.int64)
    return table["values"][f, s, 0].numpy().reshape(-1, 8), f, 0


@pytest.mark.parametrize("sections, min_size_0, want", [
    ([(0, 0), (1, 1)], 0.5, 0.0),                   # the rule's answer
    ([(0, 1), (1, 1)], 0.5, 0.0),                   # the other side of the tie
    ([(1, 1)], 0.005, 0.0),                         # a tied section dropped for its size
    ([(1, 1)], 0.5, 0.4 - ref_serve.MIN_SIZE),      # frustum 0 left out: its tied boxes' size
    ([(0, 0), (0, 1), (1, 1)], 0.5, ref_serve.MISMATCH),  # two in one frustum
], ids=["rule", "tie", "dropped", "left-out", "two"])
def test_top_reads_each_frustums_count(sections, min_size_0, want):
    table = tied_table(min_size_0)
    got = ref_sun.compare(served(table, sections), table, "top")
    assert got["box_gap"] == 0.0 and got["decision_gap"] == pytest.approx(want, abs=1e-12)
    limit = common.load_json("limits", f"{CELL}.json")["decision_gap"]
    assert (got["decision_gap"] > limit) == (want > 0)


def test_the_section_rule_alone_misses_a_frustum_left_out_at_a_tie():
    """Why 'top' reads each frustum: the section rule reads the lead of 0."""
    table = tied_table()
    sv = served(table, [(1, 1)])
    assert ref_serve.compare(sv, ref_sun.rule_table(table, "top"))["decision_gap"] == 0.0
