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


def test_port_imports_no_jax():
    """The port's engines, model, train step, profiler and ops load without
    jax, flax or optax."""
    code = (
        "import sys\n"
        "import frustum_convnet_tpu_torch.engine.test\n"
        "import frustum_convnet_tpu_torch.engine.checkpoints\n"
        "import frustum_convnet_tpu_torch.models.net\n"
        "import frustum_convnet_tpu_torch.models.det\n"
        "import frustum_convnet_tpu_torch.models.weights\n"
        "import frustum_convnet_tpu_torch.ops.select_cuda\n"
        "import frustum_convnet_tpu_torch.ops.grouping_cases\n"
        "import frustum_convnet_tpu_torch.parallel.train_step\n"
        "import frustum_convnet_tpu_torch.engine.train\n"
        "import frustum_convnet_tpu_torch.tools.profile_stages\n"
        "import frustum_convnet_tpu_torch.core.iou\n"
        "import frustum_convnet_tpu_torch.core.geometry\n"
        "import frustum_convnet_tpu_torch.models.losses\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


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
