"""The port's copy of the KITTI driver's host postprocess, and its device
selection, against the JAX driver's, side by side on the CPU.

``frustum_convnet_tpu_torch/engine/test.py`` carries the JAX driver's numpy
postprocess (``_accumulate_detections``, ``postprocess_packed``), because
the JAX module imports jax at the top, and selects on the device
(``kitti_rule``, ``compact_sections``, ``take_sections``) what JAX's
``select_foreground_batch`` selects on the host. The same seeded numpy
arrays go through both, for 'top' and 'nms', on batches with padding rows
past ``_real``, a frustum with no foreground section (the argmax fallback),
degenerate sizes (dropped), with and without the 2D detector's probability
and the refine stage's ``ref_center``. The selection and the packed path
over one batch's full decode must give exactly what JAX's
``select_foreground_batch`` and ``postprocess_batch`` give: the same index
arrays, counts and detection dicts, number for number.
"""

import types

import numpy as np
import pytest
import torch

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


def _packed(rng):
    packed = rng.normal(0, 2, (B, CAP, 8)).astype(np.float32)
    packed[..., 4:7] = np.abs(packed[..., 4:7]) + 0.5
    packed[2, 0, 6] = 0.001  # a degenerate height
    cnt = rng.integers(0, CAP + 1, B).astype(np.int32)
    cnt[REAL:] = CAP + 3  # padding rows past _real never count
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


def _packed_path(out: dict, method: str):
    """The port's device selection over a full decode (numpy arrays in
    ``out``): ``kitti_rule``, ``compact_sections`` and ``take_sections``, as
    ``build_infer_group_fn`` runs them. Returns (sel, cnt, packed) as numpy."""
    dev = {k: torch.from_numpy(v) for k, v in out.items()}
    fg, value = ttest.kitti_rule(dev, method != "nms")
    sel, cnt = ttest.compact_sections(dev["cls_probs"][:, :, 1], fg)
    packed = ttest.take_sections(sel, dev["centers"], dev["headings"], dev["sizes"], value)
    return sel.numpy(), cnt.numpy(), packed.numpy()


@pytest.mark.parametrize("method", ["top", "nms"])
def test_compact_sections_matches_jax_selection(method):
    """At S = L ('nms') or 1 ('top') the port selects, frustum by frustum
    and in the same order, the sections JAX's host selection takes."""
    rng = np.random.default_rng(21)
    out = _out(rng)
    out["cls_probs"][2] = 0.5  # ties everywhere: the argmax takes the first
    sel, cnt, _ = _packed_path(out, method)
    assert sel.shape == (B, L if method == "nms" else 1)
    for real in (REAL, B, 0):
        det_b, det_s = np.nonzero(np.arange(sel.shape[1])[None, :] < cnt[:real, None])
        _same((det_b, sel[det_b, det_s]),
              jtest.select_foreground_batch(out["cls_probs"], real, method), f"real={real}")


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("method", ["top", "nms"])
def test_packed_path_matches_jax_full_decode(method, flags):
    """The one serving path against the full decode it replaced: the
    device selection, the packing and ``postprocess_packed`` over one
    batch's full decode give exactly the detections and the count of JAX's
    ``postprocess_batch``."""
    rng = np.random.default_rng(22)
    dataset, out = _dataset(rng), _out(rng)
    batch = _batch(rng, *FLAGS[flags])
    _, cnt, packed = _packed_path(out, method)
    got, want = {}, {}
    n_got = ttest.postprocess_packed(packed, cnt, batch, dataset, got)
    n_want = jtest.postprocess_batch(out, batch, dataset, method, want)
    _same((n_got, got), (n_want, want))
    assert n_got > 0 and sum(len(r) for d in got.values() for r in d.values()) == n_got


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("cap", [CAP], ids=["within_cap"])
def test_postprocess_packed_matches_jax(cap, flags):
    """JAX's takes its cap, the packed width, and never overflows here."""
    rng = np.random.default_rng(23)
    dataset, (packed, cnt) = _dataset(rng), _packed(rng)
    batch = _batch(rng, *FLAGS[flags])
    got, want = {}, {}
    n_got = ttest.postprocess_packed(packed, cnt, batch, dataset, got)
    n_want, overflow = jtest.postprocess_packed(packed, cnt, batch, dataset, want, cap)
    _same((n_got, got), (n_want, want))
    assert not overflow and n_got > 0


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
