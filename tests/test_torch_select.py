"""The port's grouping ops on the CPU against the JAX package, bit for bit.

The plain PyTorch versions (``frustum_convnet_tpu_torch/ops/query_depth_point``)
are what the CUDA kernels are held to on the card
(``tests/test_torch_select_cuda.py``); here they are held to the JAX
package's numpy oracle ``query_depth_point_np`` and to its three Pallas
kernels in interpret mode (``group_depth_point_multi``,
``group_depth_point_pallas``, ``query_depth_point_pallas``), on every case of
``tests/test_select_pallas.py``. ``PointNetScale(grouped=None)``, which groups
for itself, is held to the Flax module with ``grouped=None``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from frustum_convnet_tpu.ops.query_depth_point import (group_points,
                                                       query_depth_point_np)
from frustum_convnet_tpu.ops.select_pallas import (group_depth_point_multi,
                                                   group_depth_point_pallas,
                                                   query_depth_point_pallas)
from frustum_convnet_tpu_torch.ops import grouping_cases, select_cuda
from frustum_convnet_tpu_torch.ops import query_depth_point as qdp

torch.set_num_threads(1)

CASES = grouping_cases.edge_cases()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _torch_multi(case):
    pts, refs, dzs, ks = case
    return qdp.group_depth_point_multi(
        torch.from_numpy(pts), [torch.from_numpy(r) for r in refs], dzs, ks)


@pytest.mark.parametrize("b,n,m,d,k", grouping_cases.ORACLE_SHAPES)
def test_query_matches_oracle(rng, b, n, m, d, k):
    zp = rng.uniform(0, 70, (b, n)).astype(np.float32)
    zr = np.sort(rng.uniform(0, 70, (b, m)).astype(np.float32), axis=1)
    idx_o, cnt_o = query_depth_point_np(zp, zr, d, k)
    idx, cnt = qdp.query_depth_point(torch.from_numpy(zp), torch.from_numpy(zr), d, k)
    assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), idx_o)
    np.testing.assert_array_equal(cnt.numpy(), cnt_o)


def _check_against_jax(case):
    """grouped and cnt equal the Pallas kernel (interpret mode) and the
    oracle select + gather + center-subtract, bit for bit."""
    pts, refs, dzs, ks = case
    got = _torch_multi(case)
    want = group_depth_point_multi(pts, refs, dzs, ks, interpret=True)
    for (g, c), (gj, cj), ref, d, k in zip(got, want, refs, dzs, ks):
        np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
        idx_o, cnt_o = query_depth_point_np(pts[..., 2], ref[..., 2], d, k)
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(group_points(pts, ref, idx_o)))
        np.testing.assert_array_equal(c.numpy(), cnt_o)
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_grouping_matches_jax_kernel_and_oracle(name):
    _check_against_jax(CASES[name])


@pytest.mark.parametrize("name", ["k_above_n_n100", "k_above_n_n201_c6"])
def test_nsample_above_point_count_matches_oracle(name):
    """K > N, which the reference's scan takes: idx, cnt and grouped of the
    plain version equal the numpy oracle's, bit for bit; every slot past
    the hits (N.. included) holds the first hit, 0 in an empty section."""
    pts, refs, dzs, ks = CASES[name]
    n = pts.shape[1]
    assert max(ks) > n
    cnts = []
    for ref, d, k in zip(refs, dzs, ks):
        idx_o, cnt_o = query_depth_point_np(pts[..., 2], ref[..., 2], d, k)
        idx, cnt = qdp.query_depth_point(torch.from_numpy(pts[..., 2].copy()),
                                         torch.from_numpy(ref[..., 2].copy()), d, k)
        np.testing.assert_array_equal(idx.numpy(), idx_o)
        np.testing.assert_array_equal(cnt.numpy(), cnt_o)
        g, c = qdp.group_depth_point(torch.from_numpy(pts), torch.from_numpy(ref), d, k)
        np.testing.assert_array_equal(g.numpy(), np.asarray(group_points(pts, ref, idx_o)))
        np.testing.assert_array_equal(c.numpy(), cnt_o)
        if k > n:
            assert (idx[..., n:] == idx[..., :1]).all()
        cnts.append(cnt_o.ravel())
    cnts = np.concatenate(cnts)
    assert (cnts > 0).any()
    if name == "k_above_n_n100":  # an empty section, and one where every point hits
        assert (cnts == 0).any() and (cnts == n).any()


def _family_spec(family):
    from frustum_convnet_tpu_torch import configs

    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(
        os.path.join(ROOT, "cfgs", grouping_cases.FAMILY_CFGS[family]), cfg)
    return configs.get_model_spec(cfg)


def _duplicated_sections(refs):
    """Sections equal to the one before them, over every scale."""
    return sum(int((np.diff(r, axis=1) == 0).all(axis=-1).sum()) for r in refs)


@pytest.mark.parametrize("family,batch", [("refine_car", 3), ("refine_people", 2),
                                          ("sunrgbd", 2), ("people", 1)])
def test_family_cases_match_jax_kernel_and_oracle(family, batch):
    """The refine case (N=512, edge-padded ladders, row 0 all zeros), the
    5-scale SUN-RGBD case (N=2048, K up to 256) and the people case (1313
    sections) through the plain version, the Pallas kernel and the oracle."""
    spec = _family_spec(family)
    if spec.ref_span is not None:
        case = grouping_cases.refine_case(spec, batch)
        assert not any(r[0].any() for r in case[1])
        assert _duplicated_sections([r[1:] for r in case[1]]) > 0
    else:
        case = grouping_cases.flagship_case(spec, batch)
    assert [r.shape[1] for r in case[1]] == list(spec.num_refs)
    assert case[0].shape == (batch, spec.num_points, 3)
    _check_against_jax(case)


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    return grouping_cases.family_datasets(os.path.join(ROOT, "cfgs"),
                                          str(tmp_path_factory.mktemp("families")))


@pytest.mark.parametrize("family", sorted(grouping_cases.FAMILY_CFGS))
def test_provider_batches_match_jax_kernel_and_oracle(families, family):
    """Batches of each family's provider over the synthetic splits (the
    refine providers' ladders are edge-padded)."""
    spec, dataset = families[family]
    case = grouping_cases.provider_case(spec, dataset, batch=2, seed=1)
    if spec.ref_span is not None:
        assert _duplicated_sections(case[1]) > 0
    out = _check_against_jax(case)
    assert any(int(c.sum()) > 0 for _, c in out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_single_scale_modes_match_jax_kernels(name):
    """Per scale: the plain versions of kernels 2 and 3 against the Pallas
    ``group_depth_point_pallas`` and ``query_depth_point_pallas`` in
    interpret mode, bit for bit; the multi-scale cases also hold kernel 1's
    contract (multi == per scale, ``test_select_pallas.py:86``)."""
    pts, refs, dzs, ks = CASES[name]
    multi = _torch_multi(CASES[name])
    for ref, d, k, (gm, cm) in zip(refs, dzs, ks, multi):
        g, c = qdp.group_depth_point(torch.from_numpy(pts), torch.from_numpy(ref), d, k)
        gj, cj = group_depth_point_pallas(pts, ref, d, k, interpret=True)
        np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
        assert torch.equal(g, gm) and torch.equal(c, cm)
        idx, cnt = qdp.query_depth_point(torch.from_numpy(pts[..., 2].copy()),
                                         torch.from_numpy(ref[..., 2].copy()), d, k)
        ij, cj = query_depth_point_pallas(pts[..., 2], ref[..., 2], d, k,
                                          interpret=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(cj))


def _emulate_group_launch(case, n_tiles, per_scale_refs):
    """The grouping kernel's launch in numpy: the section table of
    ``select_cuda.section_table``, walked tile by tile as the CUDA blocks walk
    it, each section written as its span of the one output buffer."""
    pts, refs, dzs, ks = case
    b, n, c = pts.shape
    ms = [r.shape[1] for r in refs]
    table, dz, begin = select_cuda.section_table(ms, ks, dzs, c, n_tiles,
                                                 per_scale_refs)
    slots = [r.reshape(b, -1) for r in refs] if per_scale_refs else \
        [np.concatenate(refs, axis=1).reshape(b, -1)]
    total = sum(b * m * k * c for m, k in zip(ms, ks))
    out = np.full(total + b * sum(ms), np.nan, np.float32)
    cnt = out.view(np.int32)
    for row in range(b):
        for t in range(n_tiles):
            for e in range(begin[t], begin[t + 1]):
                k, m_scale, m_local, g_prefix, c_prefix, slot, col = table[e]
                center = slots[slot][row, col:col + 3]
                hits = np.flatnonzero(np.abs(pts[row, :, 2] - center[2]) < dz[e])
                sel = np.full(k, hits[0] if len(hits) else 0)
                sel[:min(len(hits), k)] = hits[:k]
                section = row * m_scale + m_local
                g0 = b * g_prefix + section * k * c
                span = pts[row, sel].copy()
                span[:, :3] -= center
                out[g0:g0 + k * c] = span.ravel()
                cnt[total + b * c_prefix + section] = min(len(hits), k)
    return select_cuda.split_outputs(torch.from_numpy(out),
                                     select_cuda.output_views(b, ms, ks, c))


@pytest.mark.parametrize("per_scale_refs", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_section_table_tiles_cover_every_section(name, per_scale_refs):
    """The launch's section table, walked as the kernel walks it, writes
    every section's span and count exactly where the plain version's
    outputs lie, bit for bit; its tiles hold every section once, longest
    first, with output bytes within one longest section of each other."""
    pts, refs, dzs, ks = CASES[name]
    b, _, c = pts.shape
    n_sections = sum(r.shape[1] for r in refs)
    n_tiles = select_cuda.num_tiles(b, n_sections, sms=132)
    got = _emulate_group_launch(CASES[name], n_tiles, per_scale_refs)
    for (g, cnt), (g0, cnt0) in zip(got, _torch_multi(CASES[name])):
        assert g.shape == g0.shape and torch.equal(g, g0)
        assert torch.equal(cnt, cnt0)
    table, _, begin = select_cuda.section_table(
        [r.shape[1] for r in refs], ks, dzs, c, n_tiles, per_scale_refs)
    assert len(table) == n_sections and begin[-1] == n_sections
    assert len({(s, col) for s, col in table[:, 5:]}) == n_sections
    loads = [table[begin[t]:begin[t + 1], 0].sum() * c for t in range(n_tiles)]
    assert max(loads) - min(loads) <= max(ks) * c
    for t in range(n_tiles):
        k_tile = table[begin[t]:begin[t + 1], 0]
        assert (np.diff(k_tile) <= 0).all()


@pytest.mark.parametrize("batch,sms,tiles", [(256, 132, 3), (64, 132, 5),
                                             (32, 132, 9), (8, 132, 16),
                                             (1, 132, 16), (32, 2, 3)])
def test_tile_count_fills_the_card(batch, sms, tiles):
    assert select_cuda.num_tiles(batch, 525, sms) == tiles
    assert select_cuda.num_tiles(batch, 3, sms) == min(tiles, 3)


@pytest.mark.parametrize("name", ["empty_and_overflow", "multi_scale_c4",
                                  "odd_spans_n201"])
def test_kernel_bound_counts_the_pairs_this_data_needs(name):
    """``kernel_bound`` charges 2 operations per selected hit (the oracle's
    cnt, summed), plus 3 per slot in the grouping modes, and its bytes come
    from the shapes; in all three modes."""
    from frustum_convnet_tpu_torch.tools.time_grouping import kernel_bound, selected_hits

    pts, refs, dzs, ks = CASES[name]
    hits = 0
    for r, d, k in zip(refs, dzs, ks):
        _, cnt = query_depth_point_np(pts[..., 2], r[..., 2], d, k)
        assert selected_hits(torch.from_numpy(pts[..., 2]),
                             torch.from_numpy(r[..., 2]), d, k) == cnt.sum()
        hits += int(cnt.sum())
    b, n, c = pts.shape
    m = sum(r.shape[1] for r in refs)
    slots = b * sum(r.shape[1] * k for r, k in zip(refs, ks))
    t_pts, t_refs = torch.from_numpy(pts), [torch.from_numpy(r) for r in refs]
    bound = kernel_bound("group_depth_point_multi", t_pts, t_refs, dzs, ks)
    assert bound["operations"] == 2 * hits + 3 * slots
    assert bound["bytes"] == 4 * (b * n * c + 4 * b * m + slots * c)
    select = kernel_bound("query_depth_point", t_pts, t_refs, dzs, ks)
    assert select["operations"] == 2 * hits
    assert select["bytes"] == 4 * (b * n + 2 * b * m + slots)


def test_kernel_bound_flagship_b256():
    """At the flagship B=256, kernels 1 and 2 are bound by their bytes even
    if every (section, point) pair were tested (so the count of tested pairs
    never set their bound, and charging selected hits leaves it as it was);
    kernel 3 is bound by bytes at 10.8 MB (scale 1) and 5.7 MB (scale 4)."""
    from frustum_convnet_tpu_torch.configs import (get_default_cfg, get_model_spec,
                                                   merge_cfg_from_file)
    from frustum_convnet_tpu_torch.tools.time_grouping import (FP32_OPS_PER_S,
                                                               HBM_BYTES_PER_S,
                                                               kernel_bound)

    cfg = get_default_cfg()
    merge_cfg_from_file(os.path.join(ROOT, "cfgs", "det_sample.yaml"), cfg)
    pts, refs, dzs, ks = grouping_cases.flagship_case(get_model_spec(cfg), batch=256)
    t_pts, t_refs = torch.from_numpy(pts), [torch.from_numpy(r) for r in refs]
    b, n, _ = pts.shape
    got = {}
    for name, scales in (("group_depth_point_multi", [0, 1, 2, 3]),
                         ("group_depth_point", [0]), ("group_depth_point", [3]),
                         ("query_depth_point", [0]), ("query_depth_point", [3])):
        rs = [t_refs[i] for i in scales]
        bound = kernel_bound(name, t_pts, rs, [dzs[i] for i in scales],
                             [ks[i] for i in scales])
        assert bound["bound_by"] == "bytes"
        assert bound["bound_ms"] == bound["bytes"] / HBM_BYTES_PER_S * 1e3
        if name != "query_depth_point":
            brute = sum(2 * b * r.shape[1] * n + 3 * b * r.shape[1] * k
                        for r, k in zip(rs, [ks[i] for i in scales]))
            assert brute / FP32_OPS_PER_S < bound["bytes"] / HBM_BYTES_PER_S
        got[(name, scales[-1])] = round(bound["bound_ms"], 4)
    assert got == {("group_depth_point_multi", 3): 0.0262,
                   ("group_depth_point", 0): 0.0095, ("group_depth_point", 3): 0.0051,
                   ("query_depth_point", 0): 0.0032, ("query_depth_point", 3): 0.0017}


SELECT_CASES = grouping_cases.select_cases()


@pytest.mark.parametrize("name", sorted(SELECT_CASES))
def test_select_cases_match_jax_kernel_and_oracle(name):
    """The select's plain version on the prefilter's hard inputs (NaN and
    +-inf, equal and ulp-apart depths, windows on bin edges, unaligned
    spans, a clustered row) against the Pallas ``query_depth_point_pallas``
    in interpret mode and the numpy oracle, bit for bit."""
    zp, zr, d, k = SELECT_CASES[name]
    idx, cnt = qdp.query_depth_point(torch.from_numpy(zp), torch.from_numpy(zr), d, k)
    ij, cj = query_depth_point_pallas(zp, zr, d, k, interpret=True)
    with np.errstate(invalid="ignore"):  # inf - inf
        io, co = query_depth_point_np(zp, zr, d, k)
    assert idx.shape == (*zr.shape, k) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(idx.numpy(), io)
    np.testing.assert_array_equal(cnt.numpy(), co)


def _assert_candidates_hold_hits(zp, zr, d):
    zp, zr = torch.as_tensor(zp), torch.as_tensor(zr)
    cand = select_cuda.depth_bin_candidates(zp, zr, d)
    hits = (zp[:, None, :] - zr[:, :, None]).abs() < d
    assert cand.shape == hits.shape
    missed = hits & ~cand
    assert not missed.any(), f"{int(missed.sum())} hits outside the candidates"
    return cand, hits


@pytest.mark.parametrize("name", sorted(SELECT_CASES) + sorted(CASES))
def test_depth_bin_candidates_hold_every_hit(name):
    """The mirror of the select kernel's prefilter keeps every hit, on every
    select case and on every scale of every grouping case."""
    if name in SELECT_CASES:
        zp, zr, d, _ = SELECT_CASES[name]
        _assert_candidates_hold_hits(zp, zr, d)
    else:
        pts, refs, dzs, _ = CASES[name]
        for r, d in zip(refs, dzs):
            _assert_candidates_hold_hits(pts[..., 2].copy(), r[..., 2].copy(), d)


@pytest.mark.parametrize("kind", ["uniform", "clustered", "non_finite", "narrow"])
def test_depth_bin_candidates_hold_every_hit_on_random_rows(kind):
    """50 seeded random rows of each kind (200 in all), with random N,
    centers (some outside the depths' range) and windows."""
    rng = np.random.default_rng(["uniform", "clustered", "non_finite", "narrow"].index(kind))
    for _ in range(50):
        n = int(rng.integers(1, 1200))
        lo, hi = sorted(rng.uniform(-100, 100, 2))
        zp = rng.uniform(lo, hi, (1, n)).astype(np.float32)
        if kind == "narrow":  # a row a few ulps wide
            base = np.float32(lo)
            zp = (base + rng.integers(-20, 21, (1, n)) * rng.integers(0, 3)
                  * np.spacing(base)).astype(np.float32)
        if kind == "clustered":
            c = rng.uniform(lo, hi)
            zp[0, rng.random(n) < 0.8] = c + rng.normal(0, 0.05 * (hi - lo) + 1e-6)
        if kind == "non_finite":
            bad = rng.random(n) < rng.uniform(0, 1)
            zp[0, bad] = rng.choice([np.nan, np.inf, -np.inf], int(bad.sum()))
        zr = rng.uniform(lo - 5, hi + 5, (1, 64)).astype(np.float32)
        zr[0, :8] = rng.choice(zp[0], 8)  # centers on point depths
        d = float(np.float32(10.0 ** rng.uniform(-7, 2)))
        _assert_candidates_hold_hits(zp, zr, d)


def test_depth_bin_prefilter_cuts_the_flagship_scan():
    """On the flagship grouping input (B=64), with 256 bins a section of
    scale 1 has about 19 candidates of 1024 points (about 7 hits), and of
    scale 4 about 70 (about 58 hits); the candidates hold every hit."""
    from frustum_convnet_tpu_torch.configs import (get_default_cfg, get_model_spec,
                                                   merge_cfg_from_file)

    cfg = get_default_cfg()
    merge_cfg_from_file(os.path.join(ROOT, "cfgs", "det_sample.yaml"), cfg)
    pts, refs, dzs, _ = grouping_cases.flagship_case(get_model_spec(cfg), batch=64)
    assert select_cuda.depth_bins(pts.shape[1]) == 256
    for i, (low, high) in ((0, (15, 25)), (3, (60, 80))):
        cand, hits = _assert_candidates_hold_hits(pts[..., 2].copy(), refs[i][..., 2].copy(),
                                                  dzs[i])
        assert low < cand.sum(-1).float().mean() < high
        assert cand.sum() < 0.1 * cand.numel()


@pytest.mark.parametrize("n,words,bins", [(1, 32, 256), (201, 32, 256), (1024, 32, 256),
                                          (2048, 64, 128), (4096, 128, 64),
                                          (16384, 512, 16), (300000, 9376, 1)])
def test_depth_bins_fit_their_shared_memory(n, words, bins):
    assert select_cuda.bitmap_words(n) == words
    assert select_cuda.depth_bins(n) == bins
    assert bins * words * 4 <= 32 * 1024 or bins == 1


@pytest.mark.parametrize("batch,m,launch", [(256, 280, (1, 16)), (132, 35, (1, 16)),
                                            (64, 280, (5, 8)), (32, 280, (9, 8)),
                                            (1, 140, (16, 8)), (8, 2, (2, 8))])
def test_select_launch_shape(batch, m, launch):
    """One 16-warp block a row once the batch fills the card's 132 SMs, else
    the grouping's tile count in blocks of 8 warps."""
    assert select_cuda.select_launch(batch, m, sms=132) == launch


def test_pointnet_scale_groups_for_itself_like_flax():
    """``PointNetScale(grouped=None)`` (``net.py:428-430``) in eval and in
    train mode against the Flax module with ``grouped=None``, on points
    with an extra channel that ``use_feature`` keeps or drops; and the same
    as passing the multi-scale grouping in."""
    import jax
    import jax.numpy as jnp

    from frustum_convnet_tpu.models.net import PointNetScale as JaxScale
    from frustum_convnet_tpu_torch.models.net import PointNetScale

    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 20, (2, 256, 4)).astype(np.float32)
    ref = np.sort(rng.uniform(0, 20, (2, 40, 3)).astype(np.float32), axis=1)
    ref[0, -4:, 2] = 60.0  # empty sections: masked before the pool
    mlp, dist, k = (16, 16, 32), 0.4, 16
    for use_feature in (False, True):
        jm = JaxScale(mlp=mlp, dist=dist, nsample=k, use_feature=use_feature)
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(ref))
        scale = PointNetScale(4 if use_feature else 3, mlp, dist, k, use_feature)
        sd = {}
        for j in range(len(mlp)):
            src, dst = f"DenseBNReLU_{j}", f"conv{j + 1}"
            sd[f"{dst}.0.weight"] = np.asarray(
                v["params"][src]["Dense_0"]["kernel"]).T[:, :, None, None]
            for a, b in (("scale", "weight"), ("bias", "bias")):
                sd[f"{dst}.1.{b}"] = np.asarray(v["params"][src]["BatchNorm_0"][a])
            for a, b in (("mean", "running_mean"), ("var", "running_var")):
                sd[f"{dst}.1.{b}"] = np.asarray(v["batch_stats"][src]["BatchNorm_0"][a])
        scale.load_state_dict({k_: torch.from_numpy(np.array(x)) for k_, x in sd.items()},
                              strict=False)
        t_pts, t_ref = torch.from_numpy(pts), torch.from_numpy(ref)
        for train in (False, True):
            scale.train(train)
            got = scale(t_pts, t_ref).detach().numpy()
            want = jm.apply(v, jnp.asarray(pts), jnp.asarray(ref), train,
                            mutable=["batch_stats"] if train else False)
            want = np.asarray(want[0] if train else want)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        feats = t_pts if use_feature else t_pts[..., :3].contiguous()
        scale.eval()
        grouped = qdp.group_depth_point_multi(feats, [t_ref], [dist], [k])[0]
        torch.testing.assert_close(scale(t_pts, t_ref, grouped),
                                   scale(t_pts, t_ref), rtol=0, atol=0)


def test_auto_dispatch_runs_plain_version_for_cpu_tensors():
    case = CASES["multi_scale_small"]
    pts, refs, dzs, ks = case
    counters = (select_cuda.group_depth_point_multi_cuda,
                select_cuda.group_depth_point_cuda,
                select_cuda.query_depth_point_cuda)
    before = [c.launches for c in counters]
    t_pts, t_refs = torch.from_numpy(pts), [torch.from_numpy(r) for r in refs]
    got = select_cuda.group_depth_point_multi_auto(t_pts, t_refs, dzs, ks)
    single = select_cuda.group_depth_point_auto(t_pts, t_refs[0], dzs[0], ks[0])
    query = select_cuda.query_depth_point_auto(
        t_pts[..., 2].contiguous(), t_refs[0][..., 2].contiguous(), dzs[0], ks[0])
    assert [c.launches for c in counters] == before
    for (g, c), (g0, c0) in zip(got, _torch_multi(case)):
        assert torch.equal(g, g0) and torch.equal(c, c0)
    assert torch.equal(single[0], got[0][0]) and torch.equal(single[1], got[0][1])
    assert torch.equal(query[1], got[0][1])


def test_kernel_wrappers_refuse_cpu_tensors():
    pts, refs, dzs, ks = CASES["multi_scale_small"]
    t_pts, t_refs = torch.from_numpy(pts), [torch.from_numpy(r) for r in refs]
    with pytest.raises(ValueError, match="CUDA"):
        select_cuda.group_depth_point_multi_cuda(t_pts, t_refs, dzs, ks)
    with pytest.raises(ValueError, match="CUDA"):
        select_cuda.group_depth_point_cuda(t_pts, t_refs[0], dzs[0], ks[0])
    with pytest.raises(ValueError, match="CUDA"):
        select_cuda.query_depth_point_cuda(t_pts[..., 2].contiguous(),
                                           t_refs[0][..., 2].contiguous(),
                                           dzs[0], ks[0])


def test_port_imports_nothing_of_the_jax_package(tmp_path):
    """In a fresh interpreter, after every module of the port is imported and
    the training and serving entry points (training also as the one rank of
    a gloo process group, through ``parallel.mesh``), the KITTI and SUN-RGBD
    prep CLIs, the SUN-RGBD driver and the protocol runners' dataset step
    have run on the CPU at a tiny size, no module of
    the JAX package (``frustum_convnet_tpu``), nor jax, flax or optax, is
    loaded."""
    code = f"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import frustum_convnet_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.engine import checkpoints
from frustum_convnet_tpu_torch.engine import test as serve
from frustum_convnet_tpu_torch.engine import train as trainer

cfg_file = {os.path.join(ROOT, "cfgs", "det_sample.yaml")!r}
tiny = ["DATA.MAX_DEPTH", "48", "DATA.NUM_SAMPLES", "128",
        "DATA.STRIDE", "(1.0, 2.0, 4.0, 8.0)",
        "DATA.HEIGHT_HALF", "(1.0, 2.0, 4.0, 8.0)",
        "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "4", "NUM_WORKERS", "1",
        "disp", "1"]
cfg = configs.get_default_cfg()
configs.merge_cfg_from_file(cfg_file, cfg)
configs.merge_cfg_from_list(tiny, cfg)
spec = configs.get_model_spec(cfg)
work = {str(tmp_path)!r}
chip_smoke.make_train_split(work + "/train", spec, num_train=8, num_val=4)
trainer.main(["--cfg", cfg_file, "--device", "cpu"] + tiny + [
    "DATA.DATA_ROOT", work + "/train", "OUTPUT_DIR", work + "/out",
    "TRAIN.MAX_EPOCH", "1"])
split = chip_smoke.make_val_split(work + "/serve", spec, num_frames=2,
                                  cars_per_frame=2)
res = serve.main(["--cfg", cfg_file, "--device", "cpu", "--gt_dir",
                  split["gt_dir"], "--idx_path", split["idx_path"]] + tiny + [
    "DATA.DATA_ROOT", split["pickle_dir"], "OUTPUT_DIR", work + "/serve_out",
    "TPU.INFER_GROUP", "1",
    "TEST.WEIGHTS", checkpoints.checkpoint_paths(work + "/out")["final"]])
assert res["stats"]["frustums"] == 4 and res["ap"] is not None, res

# one child rank: the trainer as rank 0 of a world-1 gloo group
import os, socket
from frustum_convnet_tpu_torch.parallel import mesh
with socket.socket() as sock:
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
os.environ.update(FRUSTUM_COORDINATOR=f"localhost:{{port}}", FRUSTUM_NUM_PROCESSES="1",
                  FRUSTUM_PROCESS_ID="0")
calls = mesh.all_reduce.calls
ranked = trainer.main(["--cfg", cfg_file, "--device", "cpu"] + tiny + [
    "DATA.DATA_ROOT", work + "/train", "OUTPUT_DIR", work + "/out_rank",
    "TRAIN.MAX_EPOCH", "1"])
assert (ranked["backend"], ranked["world"]) == ("gloo", 1), ranked
assert mesh.all_reduce.calls > calls and not mesh.initialized()
for key in ("FRUSTUM_COORDINATOR", "FRUSTUM_NUM_PROCESSES", "FRUSTUM_PROCESS_ID"):
    del os.environ[key]

# the prep CLIs and the SUN-RGBD driver
from frustum_convnet_tpu_torch.data.kitti import prepare, prepare_refine
from frustum_convnet_tpu_torch.data.kitti.synthetic import make_synthetic_kitti
from frustum_convnet_tpu_torch.data.sunrgbd import ingest
from frustum_convnet_tpu_torch.data.sunrgbd import prepare as sun_prepare
from frustum_convnet_tpu_torch.data.sunrgbd.synthetic import make_synthetic_sunrgbd
from frustum_convnet_tpu_torch.engine import test_sunrgbd
make_synthetic_kitti(work + "/kitti", num_frames=2, cars_per_frame=1)
prepare.main(["--car_only", "--gen_val_rgb_detection", "--data_root", work + "/kitti",
              "--rgb_det_dir", work + "/kitti/rgb_detections", "--save_dir", work + "/p1"])
prepare_refine.main(["--car_only", "--gen_val", "--data_root", work + "/kitti",
                     "--save_dir", work + "/p2"])
make_synthetic_sunrgbd(work + "/sun", num_frames=2, objects_per_frame=1)
sun_prepare.main(["--gen_val_rgb_detection", "--sunrgbd_dir", work + "/sun",
                  "--det_file", work + "/sun/det_val.txt", "--save_dir", work + "/p3"])
sun = test_sunrgbd.main(["--cfg", {os.path.join(ROOT, "cfgs", "det_sample_sunrgbd.yaml")!r},
                         "--device", "cpu", "--sunrgbd_dir", work + "/sun", "--val_idx",
                         work + "/sun/image_sets/val.txt", "DATA.NUM_SAMPLES", "256",
                         "DATA.MAX_DEPTH", "2", "TEST.BATCH_SIZE", "2", "NUM_WORKERS", "1",
                         "OVER_WRITE_TEST_FILE", work + "/p3/sunrgbd_rgb_det_val.pickle",
                         "OUTPUT_DIR", work + "/sun_out"])
assert sun["stats"]["frustums"] >= 1 and sun["ap"] is not None, sun

# the protocol runners (both run end to end in tests/test_torch_protocol.py)
from frustum_convnet_tpu_torch.tools import run_refine_protocol, run_synth_protocol
kitti_root, _ = run_synth_protocol.build_dataset(2, 1, work + "/proto", 1)
assert run_refine_protocol.build_dataset is run_synth_protocol.build_dataset
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("frustum_convnet_tpu", "jax", "jaxlib", "flax", "optax"))
assert not bad, bad
print("standalone ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "standalone ok" in proc.stdout, proc.stderr[-4000:]


def test_profiler_stages_run_on_cpu_and_timing_needs_a_card():
    """Every stage of ``tools/profile_stages`` runs (on the plain versions
    here) at a tiny shape, and the same grouping reaches the select and
    self-grouping stages; so do the bfloat16 stages (``--dtype bfloat16``),
    whose grouping stays float32 and whose heads give float32; timing
    refuses to run without a card, whatever the dtype."""
    import __graft_entry__ as graft
    from frustum_convnet_tpu_torch.tools import profile_stages

    _cfg, spec, _ = graft._flagship(tiny=True)
    stages = dict(profile_stages.build_stages(spec, 2, torch.device("cpu")))
    assert len(stages) == 5 + 2 * spec.num_scales
    with torch.inference_mode():
        outs = {name: fn() for name, fn in stages.items()}
    multi = outs["multi-scale fused grouping (1 launch)"]
    for i, (m, k) in enumerate(zip(spec.num_refs, spec.nsamples)):
        idx, cnt = outs[f"query cuda scale{i + 1} (M={m},K={k})"]
        assert idx.shape == (2, m, k) and torch.equal(cnt, multi[i][1])
        pooled = outs[f"pointnet scale{i + 1} self-grouping (M={m},K={k})"]
        torch.testing.assert_close(
            pooled, outs["pointnet MLP stage (grouping precomputed)"][i], rtol=0, atol=0)
    bf16 = dict(profile_stages.build_stages(spec, 2, torch.device("cpu"),
                                            torch.bfloat16))
    with torch.inference_mode():
        cls, reg = bf16["forward only"]()
        pooled = bf16["pointnet MLP stage (grouping precomputed)"]()
        grouped = bf16["multi-scale fused grouping (1 launch)"]()
    assert cls.dtype == reg.dtype == torch.float32 and torch.isfinite(reg).all()
    assert all(p.dtype == torch.bfloat16 for p in pooled)
    assert all(g.dtype == torch.float32 and torch.equal(g, gm) and torch.equal(c, cm)
               for (g, c), (gm, cm) in zip(grouped, multi))
    if not torch.cuda.is_available():
        for dtype in ("float32", "bfloat16", "float16"):
            with pytest.raises(RuntimeError, match="CUDA card"):
                profile_stages.main(["--batch", "2", "--dtype", dtype])
