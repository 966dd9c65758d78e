"""Seeded numpy inputs for the grouping op, shared by its tests and
``chip_smoke.py``.

The edge cases mirror ``tests/test_select_pallas.py`` (single-scale oracle
shapes, unsorted and duplicated ladders, empty and overflow sections,
duplicate depths, N not a power of two, multi-scale ladders, K=256 with
C=6), and unaligned section spans and rows (``odd_spans_n201``);
``flagship_case`` is the model's own grouping input (the flagship, people
and SUN-RGBD specs), ``refine_case`` the refine stage's, and
``provider_case`` a batch of a family's provider (``family_datasets``,
over synthetic splits that the port's prep writes). Every case is
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

    # nsample above the point count (the reference's scan allows it; the
    # slots past the hits, N.. included, take the first hit): sections with
    # no hit, some hits and every point a hit, K a multiple of 4 and not,
    # mixed with scales whose K <= N
    zp = rng.uniform(0, 10, (2, 100)).astype(np.float32)
    zr = np.sort(rng.uniform(-1, 11, (2, 24)).astype(np.float32), axis=1)
    zr[:, 0], zr[:, -1] = 5.0, 40.0  # every point / no point in the window
    cases["k_above_n_n100"] = (_points(rng, zp, 3), [_refs(rng, zr)], [6.0], [160])
    pts = rng.uniform(-3, 8, (2, 201, 6)).astype(np.float32)
    refs = [np.sort(rng.uniform(0, 8, (2, m, 3)).astype(np.float32), axis=1)
            for m in (20, 10, 5)]
    cases["k_above_n_n201_c6"] = (pts, refs, [0.4, 1.6, 6.4], [64, 256, 301])
    return cases


def select_cases(seed: int = 4) -> dict:
    """Inputs of the select alone (kernel 3) that stress its depth-bin
    prefilter, apart from ``edge_cases`` because NaN never compares equal
    in the grouped outputs: NaN and +-inf depths and centers (one row with
    no finite depth), equal depths, depths a few ulps apart, window edges
    exactly on point depths and on bin edges, unaligned rows and idx spans
    (N=201, K=5 and 7), and a clustered row (2000 of 2048 points at
    20+-1 m, K=256). Every case is ``(z_points (B, N) f32, z_ref (B, M) f32,
    dis_z, nsample)``; all but the clustered row have N <= 512."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    special = np.array([np.nan, np.inf, -np.inf], f32)
    cases = {}

    zp = rng.uniform(0, 70, (3, 256)).astype(f32)
    for row, count in ((0, 24), (1, 128)):
        zp[row, rng.choice(256, count, replace=False)] = rng.choice(special, count)
    zp[2] = rng.choice(special, 256)
    zr = np.sort(rng.uniform(0, 70, (3, 48)).astype(f32), axis=1)
    zr[:, :3] = special
    cases["non_finite"] = (zp, zr, 1.0, 16)

    zp = np.stack([np.full(128, 12.5, f32), np.zeros(128, f32)])
    zr = np.array([[12.5, 12.0, 13.0, 12.25, 12.75, 11.0, 14.0, 0.0],
                   [0.0, 0.5, -0.5, 0.25, -0.25, 1.0, 12.5, 0.49999997]], f32)
    cases["equal_depths"] = (zp, zr, 0.5, 8)

    # rows a few ulps wide around 30 and 0.001; windows of 3 ulps
    ulps = rng.integers(-5, 6, (2, 160))
    base = np.array([[30.0], [0.001]], f32)
    step = np.spacing(base)
    zp = (base + ulps * step).astype(f32)
    zr = (base + np.arange(-7, 8)[None] * step).astype(f32)
    cases["ulps_apart"] = (zp, zr, float(3 * step[0, 0]), 8)
    cases["ulps_apart_wide_window"] = (zp, zr, 0.25, 32)

    # depths on a 0.25 m grid over [0, 64]: 128 bins of exactly 0.5 m, and
    # windows of 0.5 m whose edges fall on point depths and on bin edges
    zp = rng.integers(0, 257, (2, 256)).astype(f32) * f32(0.25)
    zp[:, :2] = [0.0, 64.0]
    zr = np.concatenate([np.arange(0, 257, 3, dtype=f32)[None].repeat(2, 0) * f32(0.25),
                         np.array([[-0.5, -0.25, 64.25, 64.5, 100.0]] * 2, f32)], axis=1)
    cases["window_on_grid_edges"] = (zp, zr, 0.5, 16)

    zp = rng.uniform(0, 30, (3, 201)).astype(f32)
    for m, d, k in ((30, 1.5, 5), (11, 3.0, 7)):
        zr = np.sort(rng.uniform(0, 30, (3, m)).astype(f32), axis=1)
        cases[f"odd_spans_n201_k{k}"] = (zp, zr, d, k)

    zp = np.concatenate([rng.uniform(19, 21, 2000), rng.uniform(0, 70, 48)])
    zp = rng.permutation(zp).astype(f32)[None]
    zr = (np.arange(140, dtype=f32) * f32(0.5) + f32(0.25))[None]
    cases["clustered_n2048_k256"] = (zp, zr, 0.5, 256)
    return cases


def flagship_case(spec, batch: int, seed: int = 0):
    """The model's grouping input at ``spec``'s shapes: synthetic frustums
    from ``data/fixtures.make_batch`` with the config's section ladders.
    With the SUN-RGBD spec this is the 5-scale case (N=2048, 80/40/20/10/5
    sections, K up to 256); with the people spec 700/350/175/88 sections."""
    b = make_batch(spec, batch=batch, seed=seed, with_labels=False)
    pts = b["point_cloud"]
    if not spec.use_extra_feature:
        pts = np.ascontiguousarray(pts[..., :3])
    return pts, list(b["refs"]), list(spec.height_half), list(spec.nsamples)


def refine_case(spec, batch: int, seed: int = 0):
    """The refine stage's grouping input at a refine ``spec``'s shapes (N=512,
    a fixed ladder of ``spec.num_refs`` sections a scale): seeded predicted
    boxes in their own frame (the provider's rotate-to-center), their
    ladders from ``FrustumRefineProvider.generate_ref``, which repeats the
    last section to fill the fixed count, and points in and around the box.
    Row 0's box has no extent, so its ladders are all zeros (the provider's
    ``n == 0`` branch)."""
    import warnings
    from types import SimpleNamespace

    from frustum_convnet_tpu_torch.core import geometry_np as gnp
    from frustum_convnet_tpu_torch.data.provider_refine import FrustumRefineProvider

    rng = np.random.default_rng(seed)
    ladder = SimpleNamespace(strides=list(spec.strides), num_refs=list(spec.num_refs))
    mean = spec.mean_size_array
    pts = np.zeros((batch, spec.num_points, 3), np.float32)
    refs = [np.zeros((batch, m, 3), np.float32) for m in spec.num_refs]
    for b in range(batch):
        size = mean[rng.integers(len(mean))] * rng.uniform(0.9, 1.1, 3) * 1.2
        if b == 0:
            size = np.zeros(3)
        corners = gnp.box3d_corners(np.zeros(3), size, 0.0)
        with warnings.catch_warnings():  # no front or back face at b == 0
            warnings.simplefilter("ignore", RuntimeWarning)
            ladders, _ = FrustumRefineProvider.generate_ref(ladder, corners)
        for r, lad in zip(refs, ladders):
            r[b] = lad
        half = np.maximum(size[[0, 2, 1]] / 2, 0.05)  # x ~ l, y ~ h, z ~ w
        pts[b] = rng.uniform(-1.3, 1.3, (spec.num_points, 3)) * half
    return pts, refs, list(spec.height_half), list(spec.nsamples)


FAMILY_CFGS = {"refine_car": "refine_car.yaml", "refine_people": "refine_people.yaml",
               "people": "det_sample_people.yaml", "sunrgbd": "det_sample_sunrgbd.yaml"}


def family_datasets(cfg_dir: str, work: str, num_frames: int = 8, seed: int = 0) -> dict:
    """One provider for each model family beyond the flagship, over
    synthetic splits that the port's own prep writes into ``work``: refine
    car and refine people (the refine prep's ground-truth path, perturbed,
    five pseudo-predictions a box, as for training), people (stage-1
    rgb-detection frustums) and SUN-RGBD (rgb-detection frustums).
    Returns {family: (spec, dataset)}; the configs are read from
    ``cfg_dir``."""
    import contextlib
    import io
    import os

    from frustum_convnet_tpu_torch import configs
    from frustum_convnet_tpu_torch.data.kitti import prepare, prepare_refine
    from frustum_convnet_tpu_torch.data.kitti.synthetic import make_synthetic_kitti
    from frustum_convnet_tpu_torch.data.registry import get_provider_class
    from frustum_convnet_tpu_torch.data.sunrgbd import prepare as sun_prepare
    from frustum_convnet_tpu_torch.data.sunrgbd.synthetic import make_synthetic_sunrgbd

    def path(*parts):
        return os.path.join(work, *parts)

    kitti = {"refine_car": ("cars", ("Car",), "frustum_caronly"),
             "refine_people": ("people", ("Pedestrian", "Cyclist"), "frustum_pedcyc")}
    for d in (*kitti, "people"):
        os.makedirs(path(d), exist_ok=True)
    with contextlib.redirect_stdout(io.StringIO()):  # the prep's progress lines
        for family, (raw, classes, prefix) in kitti.items():
            make_synthetic_kitti(path(raw), num_frames=num_frames, cars_per_frame=4,
                                 seed=seed, classes=classes)
            prepare_refine.extract_frustum_data(
                path(raw, "image_sets", "val.txt"), "training",
                path(family, f"{prefix}_val.pickle"), path(raw), perturb_box3d=True,
                augmentX=5, type_whitelist=classes, seed=seed)
        prepare.extract_frustum_data_rgb_detection(
            path("people", "rgb_detections", "rgb_detection_val.txt"), "training",
            path("people", "frustum_pedcyc_val_rgb_detection.pickle"),
            path("people"), type_whitelist=("Pedestrian", "Cyclist"))
        make_synthetic_sunrgbd(path("sunrgbd"), num_frames=num_frames, objects_per_frame=4,
                               seed=seed)
        sun_prepare.extract_frustum_data_rgb_detection(
            path("sunrgbd"), path("sunrgbd", "det_val.txt"), "training",
            path("sunrgbd", "rgb_det_val.pickle"))
    out = {}
    for family, cfg_file in FAMILY_CFGS.items():
        cfg = configs.get_default_cfg()
        configs.merge_cfg_from_file(os.path.join(cfg_dir, cfg_file), cfg)
        configs.merge_cfg_from_list(["DATA.DATA_ROOT", path(family)], cfg)
        spec = configs.get_model_spec(cfg)
        rgb = family in ("people", "sunrgbd")
        out[family] = (spec, get_provider_class(cfg)(
            cfg, "val", one_hot=True, from_rgb_detection=rgb,
            overwritten_data_path=path("sunrgbd", "rgb_det_val.pickle")
            if family == "sunrgbd" else ""))
    return out


def provider_case(spec, dataset, batch: int, seed: int = 0):
    """The grouping input of ``batch`` items of ``dataset`` (indices cycled
    over the split; each item draws its points from one seeded rng), as the
    drivers' loaders prepare them."""
    rng = np.random.default_rng(seed)
    items = [dataset.__getitem__(i % len(dataset), rng) for i in range(batch)]
    pts = np.stack([it["point_cloud"] for it in items])
    refs = [np.stack([it["refs"][s] for it in items]) for s in range(spec.num_scales)]
    return pts, refs, list(spec.height_half), list(spec.nsamples)
