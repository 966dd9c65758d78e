"""The port's geometry and paired rotated IoU against JAX and the numpy oracles.

Same numpy-seeded boxes and points through ``frustum_convnet_tpu_torch.core``
and its twins in ``frustum_convnet_tpu/core/{geometry,iou}.py`` and
``core/{geometry_np,iou_np}.py``:

* geometry: float32 within 1e-5 of JAX (the backends round ``cos``/``sin``
  differently), float64 within 1e-12 of JAX and of the numpy oracle;
* ``iou_pair_3d`` on random, identical, disjoint, contained and degenerate
  pairs (edge- and vertex-touching, a sliver, a 45-degree cross, a flat box,
  near-coincident boxes): float64 within 1e-9 of JAX in float64, float32
  within 1e-5 of JAX in float32, both within 2e-4 of the polygon-clipping
  oracle (the tolerance ``tests/test_iou.py`` holds JAX to). The candidate
  vertices are sorted by angle with a stable sort on both sides; a tie
  between two candidate angles that round differently could still order a
  ring differently, which the tolerance covers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frustum_convnet_tpu.core import geometry as jgeo
from frustum_convnet_tpu.core import geometry_np as gnp
from frustum_convnet_tpu.core import iou as jiou
from frustum_convnet_tpu.core import iou_np
from frustum_convnet_tpu_torch.core import geometry as tgeo
from frustum_convnet_tpu_torch.core import iou as tiou

torch.set_num_threads(1)

TOL = {np.float32: dict(rtol=1e-5, atol=1e-5), np.float64: dict(rtol=1e-12, atol=1e-12)}


def _boxes(rng, n, spread=3.0):
    centers = np.stack([rng.uniform(-spread, spread, n), rng.uniform(-1, 1, n),
                        rng.uniform(-spread, spread, n)], axis=1)
    sizes = rng.uniform(0.5, 4.0, (n, 3))
    headings = rng.uniform(-np.pi, np.pi, n)
    return centers, sizes, headings


def _jax(fn, *args, dtype):
    with jax.enable_x64(dtype == np.float64):
        return np.asarray(jax.jit(fn)(*[jnp.asarray(a, dtype) for a in args]))


def _torch(fn, *args, dtype):
    out = fn(*[torch.from_numpy(np.asarray(a, dtype)) for a in args])
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_box3d_corners(dtype):
    c, s, h = _boxes(np.random.default_rng(0), 64)
    got = _torch(tgeo.box3d_corners, c, h, s, dtype=dtype)
    assert got.shape == (64, 8, 3) and got.dtype == dtype
    np.testing.assert_allclose(got, _jax(jgeo.box3d_corners, c, h, s, dtype=dtype),
                               **TOL[dtype])
    want = np.stack([gnp.box3d_corners(c[i], s[i], h[i]) for i in range(64)])
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rotate_points_along_y(dtype):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-20, 20, (3, 50, 4))  # an extra channel passes through
    ang = rng.uniform(-np.pi, np.pi, 3)
    got = _torch(tgeo.rotate_points_along_y, pts, ang, dtype=dtype)
    np.testing.assert_allclose(
        got, _jax(jgeo.rotate_points_along_y, pts, ang, dtype=dtype), **TOL[dtype])
    want = np.stack([gnp.rotate_pc_along_y(pts[b], ang[b]) for b in range(3)])
    np.testing.assert_allclose(got, want, rtol=TOL[dtype]["rtol"],
                               atol=20 * TOL[dtype]["atol"])


def test_points_in_box3d_and_projection():
    rng = np.random.default_rng(2)
    c, s, h = _boxes(rng, 4)
    pts = c[:, None, :] + rng.uniform(-2.5, 2.5, (4, 200, 3))
    got = _torch(tgeo.points_in_box3d, pts, c, s, h, dtype=np.float64)
    assert got.dtype == bool and 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, _jax(jgeo.points_in_box3d, pts, c, s, h,
                                            dtype=np.float64))
    for b in range(4):
        np.testing.assert_array_equal(got[b], gnp.points_in_box3d(pts[b], c[b], s[b], h[b]))

    P = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                  [0.0, 721.5377, 172.854, 0.2163791],
                  [0.0, 0.0, 1.0, 0.002745884]])
    uvd = np.stack([rng.uniform(0, 1242, (2, 30)), rng.uniform(0, 375, (2, 30)),
                    rng.uniform(1, 70, (2, 30))], axis=-1)
    Ps = np.stack([P, P * 1.01])
    got = _torch(tgeo.project_image_to_rect, uvd, Ps, dtype=np.float64)
    np.testing.assert_allclose(
        got, _jax(jgeo.project_image_to_rect, uvd, Ps, dtype=np.float64), **TOL[np.float64])
    for b in range(2):
        np.testing.assert_allclose(got[b], gnp.project_image_to_rect(uvd[b], Ps[b]),
                                   **TOL[np.float64])


def _iou_pairs():
    """(corners1, corners2) (N, 8, 3): random near and far pairs plus the
    degenerate cases of ``tests/test_iou.py``."""
    rng = np.random.default_rng(3)
    params = []
    for i in range(48):
        c, s, h = (x[0] for x in _boxes(rng, 1))
        if i % 2:
            other = (c + rng.normal(0, 0.3, 3), np.maximum(s + rng.normal(0, 0.2, 3), 0.2),
                     h + rng.normal(0, 0.3))
        else:
            other = tuple(x[0] for x in _boxes(rng, 1))
        params.append(((c, s, h), other))
    same = ((0.5, 0.2, 1.0), (3.9, 1.6, 1.5), 0.4)
    params += [
        (same, same),                                                   # identical
        (((0, 0, 0), (2, 2, 2), 0.3), ((100, 0, 100), (2, 2, 2), -0.5)),  # disjoint
        (((0, 0, 0), (4, 4, 4), 0.7), ((0, 0, 0), (2, 2, 2), -0.2)),      # contained
        (((0, 0, 0), (2, 2, 2), 0.0), ((2, 0, 0), (2, 2, 2), 0.0)),       # edge touch
        (((0, 0, 0), (2, 2, 2), 0.0), ((2, 0, 2), (2, 2, 2), 0.0)),       # vertex touch
        (((0, 0, 0), (4, 2, 1.5), 0.3), ((0, 0, 0), (4, 2, 1.5), 0.3 + 1e-7)),
        (((0, 0, 0), (2, 2, 2), 0.0), ((1.999, 0, 0), (2, 2, 2), 0.0)),   # sliver
        (((0, 0, 0), (4, 1, 1), 0.0), ((0, 0, 0), (4, 1, 1), np.pi / 4)),  # cross
        (((0, 0, 0), (2, 2, 1e-6), 0.1), ((0.1, 0, 0.1), (2, 2, 1.0), 0.2)),  # flat
        (((0, 0, 0), (2, 2, 2), 0.0), ((0, 5, 0), (2, 2, 2), 0.0)),       # BEV only
    ]
    for _ in range(8):  # near-coincident
        c, s, h = rng.uniform(-3, 3, 3), rng.uniform(0.5, 3.0, 3), rng.uniform(-np.pi, np.pi)
        params.append(((c, s, h), (c + rng.normal(0, 1e-4, 3), s, h + rng.normal(0, 1e-4))))
    c1 = np.stack([gnp.box3d_corners(np.asarray(a[0], float), np.asarray(a[1], float), a[2])
                   for a, _ in params])
    c2 = np.stack([gnp.box3d_corners(np.asarray(b[0], float), np.asarray(b[1], float), b[2])
                   for _, b in params])
    return c1, c2


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_iou_pair_3d(dtype):
    c1, c2 = _iou_pairs()
    got_bev, got_3d = _torch(tiou.iou_pair_3d, c1, c2, dtype=dtype)
    assert got_bev.shape == (len(c1),) and got_bev.dtype == dtype
    want_bev, want_3d = (np.asarray(x) for x in _jax_iou(c1, c2, dtype))
    tol = 1e-9 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got_bev, want_bev, rtol=0, atol=tol)
    np.testing.assert_allclose(got_3d, want_3d, rtol=0, atol=tol)
    for i in range(len(c1)):
        bev_n, i3d_n = iou_np.rotated_iou_3d_np(c1[i], c2[i])
        np.testing.assert_allclose(got_bev[i], bev_n, atol=2e-4, err_msg=f"pair {i}")
        np.testing.assert_allclose(got_3d[i], i3d_n, atol=2e-4, err_msg=f"pair {i}")
    # identical, disjoint, contained (the 48 random pairs come first)
    np.testing.assert_allclose(got_3d[48:51], [1.0, 0.0, 8.0 / 64.0], atol=1e-5)
    assert got_bev[57] == pytest.approx(1.0, abs=1e-5) and got_3d[57] == 0.0


def _jax_iou(c1, c2, dtype):
    with jax.enable_x64(dtype == np.float64):
        return jax.jit(jiou.iou_pair_3d)(jnp.asarray(c1, dtype), jnp.asarray(c2, dtype))


def test_quad_helpers_match_jax():
    """``_ensure_ccw`` flips clockwise quads; ``_points_in_quad`` holds a
    quad's own vertices inside it; areas match the JAX helpers."""
    rng = np.random.default_rng(4)
    c, s, h = _boxes(rng, 16)
    quads = np.stack([gnp.box3d_corners(c[i], s[i], h[i])[:4, ::2] for i in range(16)])
    quads[::2] = quads[::2, ::-1]  # clockwise half
    t = torch.from_numpy(quads)
    ccw = tiou._ensure_ccw(t)
    with jax.enable_x64():
        want = np.stack([np.asarray(jiou._ensure_ccw(jnp.asarray(q))) for q in quads])
    np.testing.assert_array_equal(ccw.numpy(), want)
    assert tiou._points_in_quad(ccw, ccw).all()
    np.testing.assert_allclose(tiou._quad_area(ccw).numpy(), s[:, 0] * s[:, 1], rtol=1e-12)
