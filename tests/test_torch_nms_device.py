"""The port's device NMS (``ops/nms_device.py``) and IoU matrices
(``core/iou.iou_matrix_{bev,3d}``) against the JAX package's
``ops/nms_jax.py`` and ``core/iou.py``, on the CPU.

* the IoU matrices within 1e-5 of JAX's (float32, IoU in [0, 1]) on random
  boxes and on degenerate pairs: identical, disjoint, touching along an
  edge, nested, and stacked in height without overlap;
* ``rotate_nms_3d_device`` gives JAX's keep lists exactly (-1 padding and
  count included) and the host NMS's (``core/nms.rotate_nms_3d``, float64)
  on the seeded sets of ``tests/test_box_overlaps_nms_jax.py``
  (n=24, thresh 0.3, max_out 16) and at n=256, max_out 64, also with a
  ``valid`` mask and with ``max_out`` below the survivors;
* ``greedy_nms_from_iou`` breaks ties between equal scores at the first
  index, as ``jnp.argmax`` does.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import nms_boxes as _boxes  # the JAX test's generator
from frustum_convnet_tpu.core import iou as jiou
from frustum_convnet_tpu.core.geometry import box3d_corners as jax_corners
from frustum_convnet_tpu.ops import nms_jax
from frustum_convnet_tpu_torch.core import iou as tiou
from frustum_convnet_tpu_torch.core import nms as host_nms
from frustum_convnet_tpu_torch.core.geometry import box3d_corners
from frustum_convnet_tpu_torch.ops import nms_device

torch.set_num_threads(1)

IOU_TOL = 1e-5
THRESH = 0.3


def _degenerate():
    """Pairs of (center, lwh, heading): box 0 against each of the others."""
    base = ([0.0, 0.0, 0.0], [2.0, 1.0, 1.5], 0.3)
    return [base, base,                                  # identical
            ([10.0, 0.0, 10.0], [2.0, 1.0, 1.5], 0.3),   # disjoint
            ([0.0, 0.0, 0.0], [2.0, 1.0, 1.5], 0.3 + np.pi),  # identical, turned half a turn
            ([2.0 * np.cos(0.3), 0.0, -2.0 * np.sin(0.3)], [2.0, 1.0, 1.5], 0.3),  # touching edge
            ([0.0, 0.0, 0.0], [1.0, 0.5, 0.5], 0.3),     # nested
            ([0.0, 1.5, 0.0], [2.0, 1.0, 1.5], 0.3),     # stacked, touching in height
            ([0.5, 0.0, 0.2], [2.0, 1.0, 1.5], 1.2)]     # rotated partial overlap


def _corner_sets(rng):
    c, s, h, _ = _boxes(rng, 12)
    deg = _degenerate()
    dc = np.array([d[0] for d in deg], np.float32)
    ds = np.array([d[1] for d in deg], np.float32)
    dh = np.array([d[2] for d in deg], np.float32)
    return {"random": (c, s, h), "degenerate": (dc, ds, dh)}


@pytest.mark.parametrize("case", ["random", "degenerate"])
@pytest.mark.parametrize("kind", ["bev", "3d"])
def test_iou_matrix_matches_jax(rng, case, kind):
    """Random boxes against the jitted JAX matrix. The degenerate pairs sit
    on the on-edge tolerance of the inside test, where XLA's FMA contraction
    under jit moves the decision (a touching pair reads 0.17, a box against
    itself 0.9999962), so they are held to JAX op by op, whose arithmetic is
    the port's."""
    c, s, h = _corner_sets(rng)[case]
    corners = box3d_corners(torch.from_numpy(c), torch.from_numpy(h), torch.from_numpy(s))
    other = corners[:5]
    if kind == "bev":
        got = tiou.iou_matrix_bev(corners[:, :4, ::2], other[:, :4, ::2])
        jfn, args = jiou.iou_matrix_bev, (corners[:, :4, ::2], other[:, :4, ::2])
    else:
        got = tiou.iou_matrix_3d(corners, other)
        jfn, args = jiou.iou_matrix_3d, (corners, other)
    jfn = jax.jit(jfn) if case == "random" else jfn
    want = np.asarray(jfn(*(jnp.asarray(a.numpy()) for a in args)))
    assert got.shape == want.shape == (len(c), 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IOU_TOL)
    if case == "degenerate":
        col = got[:, 0].numpy()  # each box against box 0
        for j in (0, 1, 3):  # itself, identical, turned half a turn
            assert col[j] == pytest.approx(1.0, abs=IOU_TOL)
        assert col[2] == 0 and col[4] < IOU_TOL  # disjoint; touching along an edge
        # stacked in height: the same footprint, no shared volume
        assert col[6] == (pytest.approx(1.0, abs=IOU_TOL) if kind == "bev" else 0.0)


def test_corners_match_jax(rng):
    c, s, h, _ = _boxes(rng, 24)
    got = box3d_corners(torch.from_numpy(c), torch.from_numpy(h), torch.from_numpy(s))
    want = np.asarray(jax_corners(jnp.asarray(c), jnp.asarray(h), jnp.asarray(s)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _jax_nms(c, s, h, sc, valid, max_out):
    f = jax.jit(partial(nms_jax.rotate_nms_3d_device, thresh=THRESH, max_out=max_out))
    keep, cnt = f(jnp.asarray(c), jnp.asarray(s), jnp.asarray(h), jnp.asarray(sc),
                  jnp.asarray(valid))
    return np.asarray(keep), int(cnt)


def _port_nms(c, s, h, sc, valid, max_out):
    keep, cnt = nms_device.rotate_nms_3d_device(
        torch.from_numpy(c), torch.from_numpy(s), torch.from_numpy(h),
        torch.from_numpy(sc), torch.from_numpy(valid), THRESH, max_out)
    assert keep.dtype == torch.int32 and keep.shape == (max_out,) and cnt.dim() == 0
    return keep.numpy(), int(cnt)


def _host_nms(c, s, h, sc, valid, max_out):
    idx = np.nonzero(valid)[0]
    dets = np.column_stack([c, s, h, sc]).astype(np.float64)[idx]
    return [int(idx[i]) for i in host_nms.rotate_nms_3d(dets, THRESH, top_k=max_out)]


# (n, max_out, valid mask): the JAX test's set, a wide one, a masked one, and
# max_out below the survivors
NMS_CASES = {"n24_out16": (24, 16, None), "n256_out64": (256, 64, None),
             "n24_masked": (24, 24, "odd"), "n24_out4": (24, 4, None),
             "n256_out256_masked": (256, 256, "half")}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_rotate_nms_3d_device_matches_jax_and_host(rng, case):
    n, max_out, mask = NMS_CASES[case]
    c, s, h, sc = _boxes(rng, n)
    valid = np.ones(n, bool)
    if mask == "odd":
        valid[1::2] = False
    elif mask == "half":
        valid[rng.permutation(n)[: n // 2]] = False
    keep, cnt = _port_nms(c, s, h, sc, valid, max_out)
    jkeep, jcnt = _jax_nms(c, s, h, sc, valid, max_out)
    np.testing.assert_array_equal(keep, jkeep)
    assert cnt == jcnt and (keep[:cnt] >= 0).all() and (keep[cnt:] == -1).all()
    assert keep[:cnt].tolist() == _host_nms(c, s, h, sc, valid, max_out)
    assert valid[keep[:cnt]].all()
    survivors = len(_host_nms(c, s, h, sc, valid, n))
    assert cnt == min(max_out, survivors)
    if case == "n24_out4":
        assert survivors > max_out


def test_greedy_ties_take_the_first_index_and_nothing_valid_keeps_nothing():
    iou = torch.zeros(5, 5)
    iou[1, 3] = iou[3, 1] = 0.9
    scores = torch.tensor([0.2, 0.7, 0.1, 0.7, 0.7])
    valid = torch.ones(5, dtype=torch.bool)
    keep, cnt = nms_device.greedy_nms_from_iou(iou, scores, valid, 0.5, 5)
    jkeep, jcnt = nms_jax.greedy_nms_from_iou(jnp.asarray(iou.numpy()),
                                              jnp.asarray(scores.numpy()),
                                              jnp.asarray(valid.numpy()), 0.5, 5)
    assert keep.tolist() == np.asarray(jkeep).tolist() == [1, 4, 0, 2, -1]
    assert int(cnt) == int(jcnt) == 4
    keep, cnt = nms_device.greedy_nms_from_iou(iou, scores, torch.zeros(5, dtype=torch.bool),
                                               0.5, 3)
    assert keep.tolist() == [-1, -1, -1] and int(cnt) == 0
