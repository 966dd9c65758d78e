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


@pytest.mark.parametrize("name", sorted(CASES))
def test_grouping_matches_jax_kernel_and_oracle(name):
    """grouped and cnt equal the Pallas kernel (interpret mode) and the
    oracle select + gather + center-subtract, bit for bit."""
    pts, refs, dzs, ks = CASES[name]
    got = _torch_multi(CASES[name])
    want = group_depth_point_multi(pts, refs, dzs, ks, interpret=True)
    for (g, c), (gj, cj), ref, d, k in zip(got, want, refs, dzs, ks):
        np.testing.assert_array_equal(g.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
        idx_o, cnt_o = query_depth_point_np(pts[..., 2], ref[..., 2], d, k)
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(group_points(pts, ref, idx_o)))
        np.testing.assert_array_equal(c.numpy(), cnt_o)


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
    """``kernel_bound``'s scan count against a loop that tests each point in
    storage order until the K-th hit, and its bytes from the shapes."""
    from frustum_convnet_tpu_torch.tools.time_grouping import kernel_bound, scanned_pairs

    pts, refs, dzs, ks = CASES[name]
    pairs = 0
    for r, d, k in zip(refs, dzs, ks):
        scale = 0
        for zp, zr in zip(pts[..., 2], r[..., 2]):
            for z in zr:
                hits = np.flatnonzero(np.abs(zp - z) < np.float32(d))
                scale += hits[k - 1] + 1 if len(hits) >= k else len(zp)
        assert scanned_pairs(torch.from_numpy(pts[..., 2]),
                             torch.from_numpy(r[..., 2]), d, k) == scale
        pairs += scale
    b, n, c = pts.shape
    slots = b * sum(r.shape[1] * k for r, k in zip(refs, ks))
    bound = kernel_bound("group_depth_point_multi", torch.from_numpy(pts),
                         [torch.from_numpy(r) for r in refs], dzs, ks)
    assert bound["operations"] == 2 * pairs + 3 * slots
    assert bound["bytes"] == 4 * (b * n * c + 4 * b * sum(r.shape[1] for r in refs)
                                  + slots * c)


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
    the training and serving entry points have run on the CPU at a tiny
    size, no module of the JAX package (``frustum_convnet_tpu``), nor jax,
    flax or optax, is loaded."""
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
    self-grouping stages; timing refuses to run without a card."""
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
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            profile_stages.main(["--batch", "2"])
    with pytest.raises(NotImplementedError, match="float32"):
        profile_stages.main(["--dtype", "bfloat16"])
