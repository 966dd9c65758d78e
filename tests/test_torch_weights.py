"""Weight carry-over into the port, and its config entry.

``from_jax`` must produce exactly what ``tools/export_reference_checkpoint
.map_to_torch`` emits (the reference state-dict layout), keep float64 when
asked, and load with ``strict=True``; a JAX ``.msgpack`` exported by that
tool loads through the port's checkpoint path as ``TEST.WEIGHTS``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from frustum_convnet_tpu.configs import get_default_cfg
from frustum_convnet_tpu.data.fixtures import make_batch
from frustum_convnet_tpu.engine.checkpoints import save_checkpoint as jax_save
from frustum_convnet_tpu.parallel.train_step import (TrainStepConfig, init_state,
                                                     make_optimizer)
from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.engine import checkpoints
from frustum_convnet_tpu_torch.models.net import FrustumConvNet
from frustum_convnet_tpu_torch.models.weights import from_jax, load_pth
from tools.export_reference_checkpoint import main as export_main
from tools.export_reference_checkpoint import map_to_torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_state():
    _cfg, spec, model = graft._flagship(tiny=True)
    b = make_batch(spec, batch=2, seed=0, with_labels=False)
    example = {"point_cloud": jnp.asarray(b["point_cloud"]),
               "one_hot": jnp.asarray(b["one_hot"]),
               "refs": tuple(jnp.asarray(r) for r in b["refs"])}
    state = init_state(model, make_optimizer(TrainStepConfig()), example, seed=5)
    return spec, model, state, b


def test_from_jax_matches_map_to_torch(tiny_state):
    spec, _model, state, _b = tiny_state
    params = jax.device_get(state.params)
    stats = jax.device_get(state.batch_stats)
    ref = map_to_torch(params, stats, spec.num_scales)
    got = from_jax(params, stats, spec.num_scales)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    FrustumConvNet(spec).load_state_dict(got, strict=True)


def test_from_jax_keeps_float64_unless_told(tiny_state):
    spec, _model, state, _b = tiny_state
    p64 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                 jax.device_get(state.params))
    s64 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                 jax.device_get(state.batch_stats))
    sd = from_jax(p64, s64, spec.num_scales)
    floats = [v for k, v in sd.items() if not k.endswith("num_batches_tracked")]
    assert all(v.dtype == torch.float64 for v in floats)
    sd32 = from_jax(p64, s64, spec.num_scales, dtype=torch.float32)
    assert all(v.dtype == torch.float32 for k, v in sd32.items()
               if not k.endswith("num_batches_tracked"))


def test_exported_msgpack_loads_as_test_weights(tiny_state, tmp_path):
    """JAX checkpoint -> tools/export_reference_checkpoint.py -> .pth ->
    the port's load_checkpoint: same forward as the JAX model."""
    spec, model, state, b = tiny_state
    src = str(tmp_path / "model.msgpack")
    dst = str(tmp_path / "model.pth")
    jax_save(src, state, epoch=7)
    export_main([src, dst, "--cfg", "cfgs/det_sample.yaml",
                 "DATA.NUM_SAMPLES", "128", "DATA.MAX_DEPTH", "16"])
    net = FrustumConvNet(spec)
    checkpoints.load_checkpoint(dst, net)
    net.eval()
    with torch.no_grad():
        cls, reg = net(torch.from_numpy(b["point_cloud"]),
                       torch.from_numpy(b["one_hot"]),
                       [torch.from_numpy(r) for r in b["refs"]])
    jcls, jreg = model.apply({"params": state.params,
                              "batch_stats": state.batch_stats},
                             jnp.asarray(b["point_cloud"]),
                             jnp.asarray(b["one_hot"]),
                             [jnp.asarray(r) for r in b["refs"]], train=False)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(reg.numpy(), np.asarray(jreg), rtol=1e-4, atol=1e-4)


def test_load_pth_accepts_wrapped_bare_and_dataparallel(tmp_path):
    _cfg, spec, _ = graft._flagship(tiny=True)
    net = FrustumConvNet(spec)
    net.reset_parameters(torch.Generator().manual_seed(0))
    sd = net.state_dict()
    wrapped, bare, dp = (str(tmp_path / f"{n}.pth") for n in ("w", "b", "dp"))
    checkpoints.save_checkpoint(wrapped, net, epoch=3)
    torch.save(sd, bare)
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, dp)
    for path in (wrapped, bare, dp):
        loaded = load_pth(path)
        assert set(loaded) == set(sd)
        assert all(torch.equal(loaded[k], v) for k, v in sd.items())
        other = FrustumConvNet(spec)
        checkpoints.load_checkpoint(path, other)
        assert all(torch.equal(other.state_dict()[k], v) for k, v in sd.items())
    torch.save({k: v for k, v in sd.items() if "cls_out" not in k}, bare)
    with pytest.raises(RuntimeError):  # strict: a missing key is an error
        checkpoints.load_checkpoint(bare, FrustumConvNet(spec))


def test_reset_parameters_is_seeded_and_scaled():
    _cfg, spec, _ = graft._flagship(tiny=False)
    a, b = FrustumConvNet(spec), FrustumConvNet(spec)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  b.state_dict().values()))
    w = a.feat_net.pointnet4.conv2[0].weight  # kaiming-normal, fan_in 256
    assert abs(w.std().item() - (2.0 / 256) ** 0.5) < 0.01
    assert torch.equal(a.cls_out.bias, torch.zeros_like(a.cls_out.bias))


def test_config_dtypes_resolve_float32_only():
    """The dtype keys resolve as the JAX package's ``models.registry`` does
    (float32 by default; bfloat16 and float16 too), and a name outside them
    raises."""
    from frustum_convnet_tpu.models import registry as jax_registry

    cfg = get_default_cfg()
    assert configs.get_compute_dtype(cfg, train=True) == torch.float32
    assert configs.get_compute_dtype(cfg, train=False) == torch.float32
    assert configs.get_trunk_dtype(cfg) is None
    assert configs.get_points_upload_dtype(cfg) == torch.float16
    cfg.TPU.INFER_POINTS_DTYPE = "float32"
    assert configs.get_points_upload_dtype(cfg) == torch.float32
    for name in ("float32", "bfloat16", "float16"):
        cfg.TPU.COMPUTE_DTYPE, cfg.TPU.INFER_DTYPE = name, "float32"
        cfg.TPU.TRUNK_DTYPE = name
        for train in (True, False):
            got = configs.get_compute_dtype(cfg, train=train)
            want = jax_registry.get_compute_dtype(cfg, train=train)
            assert str(got).split(".")[-1] == jnp.dtype(want).name
        assert configs.get_trunk_dtype(cfg) == getattr(torch, name)
        assert jnp.dtype(jax_registry.get_trunk_dtype(cfg)).name == name
    cfg.TPU.INFER_DTYPE = "bfloat16"
    assert configs.get_compute_dtype(cfg, train=False) == torch.bfloat16
    for key in ("COMPUTE_DTYPE", "INFER_DTYPE", "TRUNK_DTYPE"):
        bad = get_default_cfg()
        bad.TPU[key] = "float64"
        with pytest.raises(KeyError, match=key):
            configs.get_compute_dtype(bad, train=key == "COMPUTE_DTYPE")
            configs.get_trunk_dtype(bad)
    cfg.TPU.INFER_POINTS_DTYPE = "bfloat16"
    with pytest.raises(ValueError):
        configs.get_points_upload_dtype(cfg)
