"""The port's copy of the KITTI driver's host postprocess against the JAX
driver's, side by side on the CPU.

``frustum_convnet_tpu_torch/engine/test.py`` carries the JAX driver's numpy
postprocess (``select_foreground_batch``, ``_accumulate_detections``,
``postprocess_batch``, ``postprocess_packed``), because the JAX module
imports jax at the top. The same seeded numpy arrays go through both
copies, for 'top' and 'nms', on batches with padding rows past ``_real``,
a frustum with no foreground section (the argmax fallback), degenerate
sizes (dropped), with and without the 2D detector's probability and the
refine stage's ``ref_center``, and a packed batch over its cap. Both
sides are numpy code, so the results must be exactly equal: the same index
arrays, counts, flags and detection dicts, number for number.
"""

import types

import numpy as np
import pytest

from frustum_convnet_tpu.engine import test as jtest
from frustum_convnet_tpu_torch.engine import test as ttest

B, REAL, L, CAP = 6, 4, 12, 5
TYPES = ("Car", "Pedestrian", "Cyclist")


def _dataset(rng, n=9):
    """The provider fields the postprocess reads: ids (two frustums share a
    frame), types and 2D boxes."""
    return types.SimpleNamespace(data={
        "id": [int(i) for i in rng.integers(0, 4, n)],
        "type": [TYPES[i] for i in rng.integers(0, 3, n)],
        "box2d": [rng.uniform(0, 600, 4).astype(np.float32) for _ in range(n)]})


def _batch(rng, rgb_prob: bool, ref_center: bool) -> dict:
    batch = {"_indices": rng.permutation(9)[:B], "_real": REAL,
             "rot_angle": rng.uniform(-np.pi, np.pi, B).astype(np.float32)}
    if rgb_prob:
        batch["rgb_prob"] = rng.uniform(0.5, 1, B).astype(np.float32)
    if ref_center:
        batch["ref_center"] = rng.normal(0, 5, (B, 3)).astype(np.float32)
    return batch


def _out(rng) -> dict:
    """A full decode: frustum 0 has no foreground section, frustum 1 a
    degenerate size in every section, the rest random."""
    logits = rng.normal(0, 1.5, (B, L, 2)).astype(np.float32)
    logits[0, :, 1] = logits[0, :, 0] - 1.0
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    sizes = rng.uniform(0.5, 4, (B, L, 3)).astype(np.float32)
    sizes[1, :, 2] = 0.005
    return {"cls_probs": probs.astype(np.float32),
            "centers": rng.normal(0, 3, (B, L, 3)).astype(np.float32),
            "headings": rng.uniform(-np.pi, np.pi, (B, L)).astype(np.float32),
            "sizes": sizes}


def _packed(rng, overflow: bool):
    packed = rng.normal(0, 2, (B, CAP, 8)).astype(np.float32)
    packed[..., 4:7] = np.abs(packed[..., 4:7]) + 0.5
    packed[2, 0, 6] = 0.001  # a degenerate height
    cnt = rng.integers(0, CAP + 1, B).astype(np.int32)
    cnt[REAL:] = CAP + 3  # padding rows past _real never count
    if overflow:
        cnt[1] = CAP + 1
    return packed, cnt


def _same(a, b, where="result"):
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


FLAGS = {"plain": (False, False), "rgb_prob": (True, False), "refine": (True, True)}


@pytest.mark.parametrize("method", ["top", "nms"])
def test_select_foreground_batch_matches_jax(method):
    rng = np.random.default_rng(21)
    probs = _out(rng)["cls_probs"]
    for real in (REAL, B, 0):
        _same(ttest.select_foreground_batch(probs, real, method),
              jtest.select_foreground_batch(probs, real, method), f"real={real}")


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("method", ["top", "nms"])
def test_postprocess_batch_matches_jax(method, flags):
    rng = np.random.default_rng(22)
    dataset, out = _dataset(rng), _out(rng)
    batch = _batch(rng, *FLAGS[flags])
    got, want = {}, {}
    n_got = ttest.postprocess_batch(out, batch, dataset, method, got)
    n_want = jtest.postprocess_batch(out, batch, dataset, method, want)
    _same((n_got, got), (n_want, want))
    assert n_got > 0 and sum(len(r) for d in got.values() for r in d.values()) == n_got


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("overflow", [False, True], ids=["within_cap", "overflow"])
def test_postprocess_packed_matches_jax(overflow, flags):
    rng = np.random.default_rng(23)
    dataset, (packed, cnt) = _dataset(rng), _packed(rng, overflow)
    batch = _batch(rng, *FLAGS[flags])
    got, want = {}, {}
    res_got = ttest.postprocess_packed(packed, cnt, batch, dataset, got, CAP)
    res_want = jtest.postprocess_packed(packed, cnt, batch, dataset, want, CAP)
    _same((res_got, got), (res_want, want))
    assert res_got[1] == overflow and (res_got[0] > 0) != overflow


def test_accumulate_detections_matches_jax():
    """The shared tail on gathered detections, appending to a dict that
    already holds rows (a frame seen in an earlier batch)."""
    rng = np.random.default_rng(24)
    dataset, batch = _dataset(rng), _batch(rng, True, True)
    d = 7
    det_b = rng.integers(0, REAL, d)
    args = (rng.normal(0, 3, (d, 3)).astype(np.float32),
            rng.uniform(-np.pi, np.pi, d).astype(np.float32),
            np.abs(rng.normal(1, 1, (d, 3))).astype(np.float32) + [0, 0, 0.004],
            rng.uniform(0, 1, d).astype(np.float32), det_b)
    first = dataset.data["id"][batch["_indices"][0]]
    got, want = {first: {"Car": [[0.0] * 12]}}, {first: {"Car": [[0.0] * 12]}}
    _same((ttest._accumulate_detections(*args, batch, dataset, got), got),
          (jtest._accumulate_detections(*args, batch, dataset, want), want))
