"""The CUDA grouping kernels against their plain PyTorch versions, on the card.

Bit for bit (grouped, idx and cnt) on every edge case of
``tests/test_select_pallas.py``, at the flagship shapes and at the other
families' (refine car and people with edge-padded ladders, people, SUN-RGBD;
synthetic cases and B=32 provider batches), for the three modes: every
scale in one launch (kernel 1), one scale (kernel 2) and the select alone
(kernel 3), nsample above the point count included. This file
imports no jax, so on a machine with the card it runs alone:

    python -m pytest --noconftest -q tests/test_torch_select_cuda.py

Here, without a card, every test skips.
"""

import numpy as np
import pytest
import torch

from frustum_convnet_tpu_torch.configs import (get_default_cfg, get_model_spec,
                                               merge_cfg_from_file, merge_cfg_from_list)
from frustum_convnet_tpu_torch.ops import grouping_cases, select_cuda
from frustum_convnet_tpu_torch.ops.query_depth_point import (group_depth_point,
                                                              group_depth_point_multi,
                                                              query_depth_point)

torch.set_num_threads(1)

CASES = grouping_cases.edge_cases()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _check(case, device):
    pts, refs, dzs, ks = case
    t_pts = torch.from_numpy(pts).to(device)
    t_refs = [torch.from_numpy(r).to(device) for r in refs]
    got = select_cuda.group_depth_point_multi_cuda(t_pts, t_refs, dzs, ks)
    want = group_depth_point_multi(t_pts, t_refs, dzs, ks)
    torch.cuda.synchronize()
    for (g, c), (g0, c0) in zip(got, want):
        assert g.shape == g0.shape and c.dtype == torch.int32
        assert torch.equal(g, g0)
        assert torch.equal(c, c0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda, name):
    _check(CASES[name], cuda)


def _check_single(case, device):
    """Kernels 2 and 3 per scale against their plain versions; kernel 2
    also against kernel 1's output for the scale."""
    pts, refs, dzs, ks = case
    t_pts = torch.from_numpy(pts).to(device)
    multi = select_cuda.group_depth_point_multi_cuda(
        t_pts, [torch.from_numpy(r).to(device) for r in refs], dzs, ks)
    z_points = t_pts[..., 2].contiguous()
    for ref, d, k, (gm, cm) in zip(refs, dzs, ks, multi):
        t_ref = torch.from_numpy(ref).to(device)
        g, c = select_cuda.group_depth_point_cuda(t_pts, t_ref, d, k)
        g0, c0 = group_depth_point(t_pts, t_ref, d, k)
        z_ref = t_ref[..., 2].contiguous()
        idx, cnt = select_cuda.query_depth_point_cuda(z_points, z_ref, d, k)
        idx0, cnt0 = query_depth_point(z_points, z_ref, d, k)
        torch.cuda.synchronize()
        assert g.shape == g0.shape and idx.shape == idx0.shape
        assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
        assert torch.equal(g, g0) and torch.equal(c, c0)
        assert torch.equal(g, gm) and torch.equal(c, cm)
        assert torch.equal(idx, idx0) and torch.equal(cnt, cnt0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_single_scale_and_select_kernels_match_plain(cuda, name):
    _check_single(CASES[name], cuda)


@pytest.mark.cuda
def test_single_scale_and_select_kernels_flagship_shapes(cuda):
    cfg = get_default_cfg()
    merge_cfg_from_file("cfgs/det_sample.yaml", cfg)
    spec = get_model_spec(cfg)
    counters = (select_cuda.group_depth_point_cuda,
                select_cuda.query_depth_point_cuda)
    before = [c.launches for c in counters]
    _check_single(grouping_cases.flagship_case(spec, batch=32), cuda)
    assert [c.launches for c in counters] == [b + 4 for b in before]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["k_above_n_n100", "k_above_n_n201_c6", "sunrgbd_n128"])
def test_kernels_take_nsample_above_point_count(cuda, name):
    """K > N: kernels 1, 2 and 3 against their plain versions, bit for bit,
    on the edge cases and on SUN-RGBD at DATA.NUM_SAMPLES 128 (K=256 on
    scales 3-5) at B=32."""
    if name == "sunrgbd_n128":
        cfg = get_default_cfg()
        merge_cfg_from_file("cfgs/det_sample_sunrgbd.yaml", cfg)
        merge_cfg_from_list(["DATA.NUM_SAMPLES", "128"], cfg)
        case = grouping_cases.flagship_case(get_model_spec(cfg), batch=32)
    else:
        case = CASES[name]
    assert max(case[3]) > case[0].shape[1]
    _check(case, cuda)
    _check_single(case, cuda)


SELECT_CASES = grouping_cases.select_cases()


def _check_select(zp, zr, d, k, device):
    z_points, z_ref = torch.as_tensor(zp).to(device), torch.as_tensor(zr).to(device)
    idx, cnt = select_cuda.query_depth_point_cuda(z_points, z_ref, d, k)
    idx0, cnt0 = query_depth_point(z_points, z_ref, d, k)
    torch.cuda.synchronize()
    assert idx.shape == idx0.shape and idx.dtype == torch.int32
    assert torch.equal(idx, idx0) and torch.equal(cnt, cnt0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SELECT_CASES))
def test_select_kernel_matches_plain_on_select_cases(cuda, name):
    """Kernel 3 on the inputs that stress its depth-bin prefilter: NaN and
    +-inf, equal and ulp-apart depths, windows on bin edges, unaligned
    spans, a clustered row."""
    _check_select(*SELECT_CASES[name], cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [32, 256])
def test_select_kernel_flagship_scales(cuda, batch):
    """Kernel 3 on all four flagship scales at the profiler's B=32 and the
    timed B=256 (3 and 9 tiles a row)."""
    cfg = get_default_cfg()
    merge_cfg_from_file("cfgs/det_sample.yaml", cfg)
    pts, refs, dzs, ks = grouping_cases.flagship_case(get_model_spec(cfg), batch=batch)
    for ref, d, k in zip(refs, dzs, ks):
        _check_select(pts[..., 2].copy(), ref[..., 2].copy(), d, k, cuda)


@pytest.mark.cuda
def test_kernel_flagship_shapes(cuda):
    cfg = get_default_cfg()
    merge_cfg_from_file("cfgs/det_sample.yaml", cfg)
    spec = get_model_spec(cfg)
    before = select_cuda.group_depth_point_multi_cuda.launches
    outs = _check(grouping_cases.flagship_case(spec, batch=32), cuda)
    assert select_cuda.group_depth_point_multi_cuda.launches == before + 1
    assert [tuple(g.shape) for g, _ in outs] == [
        (32, m, k, 3) for m, k in zip(spec.num_refs, spec.nsamples)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 64, 130])
def test_kernel_flagship_batches(cuda, batch):
    """Every tile count the batch gives (16 at B=1 down to 3 at B=130)."""
    cfg = get_default_cfg()
    merge_cfg_from_file("cfgs/det_sample.yaml", cfg)
    _check(grouping_cases.flagship_case(get_model_spec(cfg), batch=batch, seed=batch), cuda)


def _family_spec(family):
    cfg = get_default_cfg()
    merge_cfg_from_file(f"cfgs/{grouping_cases.FAMILY_CFGS[family]}", cfg)
    return get_model_spec(cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(grouping_cases.FAMILY_CFGS))
@pytest.mark.parametrize("batch", [3, 32])
def test_kernel_family_shapes(cuda, family, batch):
    """The refine cases (N=512, edge-padded ladders, row 0 all zeros, so
    each row scans a NaN-padded 1024-point chunk), SUN-RGBD (N=2048, 5
    scales, K up to 256) and people (1313 sections)."""
    spec = _family_spec(family)
    case = (grouping_cases.refine_case(spec, batch) if spec.ref_span is not None
            else grouping_cases.flagship_case(spec, batch))
    _check(case, cuda)
    _check_single(case, cuda)


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return grouping_cases.family_datasets("cfgs", str(tmp_path_factory.mktemp("families")))


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(grouping_cases.FAMILY_CFGS))
def test_kernel_family_provider_batches(cuda, families, family):
    """Kernels 1, 2 and 3 on a B=32 batch of each family's provider."""
    spec, dataset = families[family]
    case = grouping_cases.provider_case(spec, dataset, batch=32, seed=2)
    _check(case, cuda)
    _check_single(case, cuda)


@pytest.mark.cuda
def test_kernel_many_scales_and_strided_refs(cuda):
    """More scales than the launch's ref pointers (the refs are then
    concatenated) and refs that are views with strides."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 20, (2, 300, 3)).astype(np.float32)
    refs = [rng.uniform(0, 20, (2, 4 + s, 3)).astype(np.float32) for s in range(18)]
    dzs = [0.2 + 0.1 * s for s in range(18)]
    ks = [1 + s for s in range(18)]
    _check((pts, refs, dzs, ks), cuda)
    t_pts = torch.from_numpy(pts).to(cuda)
    wide = torch.from_numpy(rng.uniform(0, 20, (2, 40, 6)).astype(np.float32)).to(cuda)
    strided = [wide[:, :, :3], wide[:, ::2, 3:]]
    got = select_cuda.group_depth_point_multi_cuda(t_pts, strided, [0.5, 1.0], [8, 16])
    want = group_depth_point_multi(t_pts, strided, [0.5, 1.0], [8, 16])
    for (g, c), (g0, c0) in zip(got, want):
        assert torch.equal(g, g0) and torch.equal(c, c0)


@pytest.mark.cuda
def test_auto_dispatch_launches_kernel_for_cuda_tensors(cuda):
    pts, refs, dzs, ks = CASES["multi_scale_small"]
    counters = (select_cuda.group_depth_point_multi_cuda,
                select_cuda.group_depth_point_cuda,
                select_cuda.query_depth_point_cuda)
    before = [c.launches for c in counters]
    t_pts = torch.from_numpy(pts).to(cuda)
    t_refs = [torch.from_numpy(r).to(cuda) for r in refs]
    select_cuda.group_depth_point_multi_auto(t_pts, t_refs, dzs, ks)
    select_cuda.group_depth_point_auto(t_pts, t_refs[0], dzs[0], ks[0])
    select_cuda.query_depth_point_auto(t_pts[..., 2].contiguous(),
                                       t_refs[0][..., 2].contiguous(), dzs[0], ks[0])
    assert [c.launches for c in counters] == [b + 1 for b in before]


@pytest.mark.cuda
def test_argmax_ties_and_topk_order_match_cpu(cuda):
    """The decode's argmax takes the first of tied maxima and the driver's
    compaction takes top-k of unique keys in ascending order, on the card
    as on the CPU."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, (256, 140)).astype(np.float32)  # many ties
    t = torch.from_numpy(x)
    assert torch.equal(torch.argmax(t.to(cuda), dim=1).cpu(), torch.argmax(t, dim=1))
    assert torch.equal(torch.argmax(t, dim=1),
                       torch.from_numpy(np.argmax(x, axis=1)))
    key = torch.from_numpy(np.stack([rng.permutation(1024) for _ in range(64)])
                           .astype(np.int32))
    for k in (1, 64, 128):
        got = torch.topk(-key.to(cuda), k, dim=1, sorted=True).values.cpu()
        assert torch.equal(got, torch.topk(-key, k, dim=1, sorted=True).values)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    pts, refs, dzs, ks = CASES["multi_scale_small"]
    t_refs = [torch.from_numpy(r).to(cuda) for r in refs]
    with pytest.raises(ValueError):
        select_cuda.group_depth_point_multi_cuda(
            torch.from_numpy(pts).to(cuda).double(), t_refs, dzs, ks)
    with pytest.raises(ValueError, match="at least 1"):
        select_cuda.group_depth_point_multi_cuda(
            torch.from_numpy(np.ascontiguousarray(pts[:, ::2])).to(cuda),
            t_refs, dzs, [0, 8])
    t_pts = torch.from_numpy(pts).to(cuda)
    with pytest.raises(ValueError, match="grad"):
        select_cuda.group_depth_point_cuda(t_pts.clone().requires_grad_(),
                                           t_refs[0], dzs[0], ks[0])
    z_ref = t_refs[0][..., 2].contiguous()
    with pytest.raises(ValueError, match="grad"):
        select_cuda.query_depth_point_cuda(
            t_pts[..., 2].contiguous().requires_grad_(), z_ref, dzs[0], ks[0])
    with pytest.raises(ValueError, match="contiguous"):
        select_cuda.query_depth_point_cuda(t_pts[..., 2], z_ref, dzs[0], ks[0])
    big = torch.zeros((1, 16384, 3), device=cuda)  # the row fits, the staging does not
    with pytest.raises(ValueError, match="staged span"):
        select_cuda.group_depth_point_multi_cuda(
            big, [torch.zeros((1, 2, 3), device=cuda)], [1.0], [8])
    # 40000 depths and their 6 bitmaps fit, one span of K=16384 indices does not
    with pytest.raises(ValueError, match="shared memory"):
        select_cuda.query_depth_point_cuda(torch.zeros((1, 40000), device=cuda),
                                           z_ref[:1], 1.0, 16384)
