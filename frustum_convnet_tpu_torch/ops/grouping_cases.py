"""Seeded numpy inputs for the grouping op, shared by its tests and
``chip_smoke.py``.

The edge cases mirror ``tests/test_select_pallas.py`` (single-scale oracle
shapes, unsorted and duplicated ladders, empty and overflow sections,
duplicate depths, N not a power of two, multi-scale ladders, K=256 with
C=6), and unaligned section spans and rows (``odd_spans_n201``);
``flagship_case`` is the model's own grouping input. Every case is
``(points (B, N, C) f32, [refs (B, M_i, 3) f32], dis_zs, nsamples)``.
"""

from __future__ import annotations

import numpy as np

from frustum_convnet_tpu_torch.data.fixtures import make_batch

# (b, n, m, dis_z, k) of test_select_pallas.test_matches_oracle
ORACLE_SHAPES = [
    (2, 1024, 280, 0.25, 32),   # KITTI scale 1
    (2, 1024, 140, 0.5, 64),    # scale 2
    (2, 1024, 35, 2.0, 128),    # scale 4 (K > 64)
    (1, 128, 16, 1.0, 8),       # tiny
    (2, 200, 50, 0.3, 8),       # N not a power of two
    (3, 512, 7, 0.5, 16),       # fewer sections than a warp's tile
]


def _points(rng, z, c, lo=-3.0, hi=70.0):
    """(B, N, C) points whose depth channel is ``z``."""
    pts = rng.uniform(lo, hi, z.shape + (c,)).astype(np.float32)
    pts[..., 2] = z
    return pts


def _refs(rng, z, lo=-2.0, hi=2.0):
    """(B, M, 3) section centers at depths ``z``."""
    r = rng.uniform(lo, hi, z.shape + (3,)).astype(np.float32)
    r[..., 2] = z
    return r


def edge_cases(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    cases = {}
    for b, n, m, d, k in ORACLE_SHAPES:
        zp = rng.uniform(0, 70, (b, n)).astype(np.float32)
        zr = np.sort(rng.uniform(0, 70, (b, m)).astype(np.float32), axis=1)
        cases[f"oracle_b{b}_n{n}_m{m}_k{k}"] = (
            _points(rng, zp, 3), [_refs(rng, zr)], [d], [k])

    zp = rng.uniform(0, 20, (2, 256)).astype(np.float32)
    zr = rng.uniform(0, 20, (2, 40)).astype(np.float32)  # unsorted
    zr[:, 30:] = zr[:, 29:30]  # repeat-last edge padding (refine ladders)
    cases["unsorted_duplicate_refs"] = (
        _points(rng, zp, 3), [_refs(rng, zr)], [0.5], [16])

    zp = np.full((1, 64), 5.0, np.float32)
    zr = np.array([[5.0, 50.0]], np.float32)  # every point / no point matches
    cases["empty_and_overflow"] = (
        _points(rng, zp, 3), [_refs(rng, zr)], [1.0], [8])

    zp = np.tile(rng.uniform(0, 10, (1, 16)).astype(np.float32), (1, 8))
    zr = np.sort(rng.uniform(0, 10, (1, 24)).astype(np.float32), axis=1)
    cases["duplicate_depths"] = (
        _points(rng, zp, 3), [_refs(rng, zr)], [0.7], [12])

    for c, k in [(3, 32), (4, 64), (6, 16)]:
        pts = rng.uniform(-3, 70, (2, 384, c)).astype(np.float32)
        ref = rng.uniform(0, 70, (2, 72, 3)).astype(np.float32)
        cases[f"fused_c{c}_k{k}"] = (pts, [ref], [0.8], [k])

    pts = rng.uniform(-3, 70, (2, 512, 4)).astype(np.float32)
    refs = [rng.uniform(0, 70, (2, m, 3)).astype(np.float32)
            for m in (140, 70, 35, 18)]
    cases["multi_scale_c4"] = (pts, refs, [0.25, 0.5, 1.0, 2.0],
                               [32, 64, 64, 128])

    pts = rng.uniform(0, 20, (1, 256, 3)).astype(np.float32)
    refs = [np.sort(rng.uniform(0, 20, (1, m, 3)).astype(np.float32), axis=1)
            for m in (50, 25)]
    cases["multi_scale_small"] = (pts, refs, [0.3, 0.6], [16, 8])

    pts = rng.uniform(-3, 8, (2, 512, 6)).astype(np.float32)
    refs = [np.sort(rng.uniform(0, 8, (2, m, 3)).astype(np.float32), axis=1)
            for m in (80, 40, 20, 10, 5)]
    cases["k256_c6_sunrgbd"] = (pts, refs, [0.1, 0.2, 0.4, 0.8, 1.6],
                                [128, 128, 256, 256, 256])

    # spans of K*C = 15 and 21 floats and rows of 603 floats: unaligned
    # section spans and row starts
    pts = rng.uniform(0, 30, (3, 201, 3)).astype(np.float32)
    refs = [np.sort(rng.uniform(0, 30, (3, m, 3)).astype(np.float32), axis=1)
            for m in (30, 11)]
    cases["odd_spans_n201"] = (pts, refs, [1.5, 3.0], [5, 7])

    return cases


def flagship_case(spec, batch: int, seed: int = 0):
    """The model's grouping input at ``spec``'s shapes: synthetic frustums
    from ``data/fixtures.make_batch`` with the config's section ladders."""
    b = make_batch(spec, batch=batch, seed=seed, with_labels=False)
    pts = b["point_cloud"]
    if not spec.use_extra_feature:
        pts = np.ascontiguousarray(pts[..., :3])
    return pts, list(b["refs"]), list(spec.height_half), list(spec.nsamples)
