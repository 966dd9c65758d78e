"""Weight carry-over into the port, and its config entry.

``from_jax`` must produce exactly what ``tools/export_reference_checkpoint
.map_to_torch`` emits (the reference state-dict layout), keep float64 when
asked, and load with ``strict=True``; a JAX ``.msgpack`` exported by that
tool loads through the port's checkpoint path as ``TEST.WEIGHTS``.

The file is also the exporter of JAX's own init for a port run (the port
imports no jax, so it cannot draw it): ``python tests/test_torch_weights.py
OUT.pth [SEED [KEY VALUE ...]]`` writes ``export_jax_init``'s trainer
checkpoint of ``cfgs/det_sample.yaml`` at ``TRAIN.SEED`` SEED (3), which
``engine.train`` takes as ``TRAIN.WEIGHTS``.
"""

import collections
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from frustum_convnet_tpu.configs import (get_default_cfg, merge_cfg_from_file,  # noqa: E402
                                         merge_cfg_from_list)
from frustum_convnet_tpu.data.fixtures import make_batch  # noqa: E402
from frustum_convnet_tpu.engine.checkpoints import save_checkpoint as jax_save  # noqa: E402
from frustum_convnet_tpu.models.net import FrustumConvNet as JaxNet  # noqa: E402
from frustum_convnet_tpu.models.registry import get_model_spec  # noqa: E402
from frustum_convnet_tpu.parallel.train_step import (TrainStepConfig, init_state,  # noqa: E402
                                                     make_optimizer)
from frustum_convnet_tpu_torch import configs  # noqa: E402
from frustum_convnet_tpu_torch.engine import checkpoints  # noqa: E402
from frustum_convnet_tpu_torch.models.net import FrustumConvNet  # noqa: E402
from frustum_convnet_tpu_torch.models.weights import from_jax, load_pth  # noqa: E402
from frustum_convnet_tpu_torch.parallel import train_step as ts  # noqa: E402
from tools.export_reference_checkpoint import main as export_main  # noqa: E402
from tools.export_reference_checkpoint import map_to_torch  # noqa: E402

torch.set_num_threads(1)

CFG = os.path.join(ROOT, "cfgs", "det_sample.yaml")


def _port_step_cfg(cfg) -> ts.TrainStepConfig:
    """The optimizer fields of ``engine.train``'s step config."""
    return ts.TrainStepConfig(base_lr=cfg.TRAIN.BASE_LR, weight_decay=cfg.TRAIN.WEIGHT_DECAY,
                              optimizer=cfg.TRAIN.OPTIMIZER, momentum=cfg.TRAIN.MOMENTUM)


def export_jax_init(path: str, seed: int = 3, overrides=()) -> dict:
    """JAX's init for ``cfgs/det_sample.yaml`` + ``overrides`` at ``seed``
    (``init_state``, as the JAX driver draws it at ``TRAIN.SEED``; it
    depends on the shapes alone), through ``from_jax``, written as a port
    trainer checkpoint at epoch 0 with the config's fresh optimizer: a port
    run given it as ``TRAIN.WEIGHTS`` starts where the JAX run started.
    Returns the state dict."""
    cfg = get_default_cfg()
    merge_cfg_from_file(CFG, cfg)
    merge_cfg_from_list(list(overrides), cfg)
    spec = get_model_spec(cfg)
    b = make_batch(spec, batch=1, seed=0, with_labels=False)
    state = init_state(JaxNet(spec), make_optimizer(TrainStepConfig()), {
        "point_cloud": jnp.asarray(b["point_cloud"]),
        "one_hot": jnp.asarray(b["one_hot"]),
        "refs": tuple(jnp.asarray(r) for r in b["refs"])}, seed=seed)
    sd = from_jax(jax.device_get(state.params), jax.device_get(state.batch_stats),
                  spec.num_scales)
    net = FrustumConvNet(spec)
    net.load_state_dict(sd, strict=True)
    step_cfg = _port_step_cfg(cfg)
    checkpoints.save_train_checkpoint(path, ts.TrainState(
        net, ts.make_optimizer(net.parameters(), step_cfg), ts.multistep_lr(step_cfg)), epoch=0)
    return sd


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


def test_reset_parameters_draws_jax_init_distributions():
    """At flagship width, JAX's ``init_state(seed=3)`` through ``from_jax``
    and the port's ``reset_parameters(manual_seed(3))`` hold the same keys
    and shapes, and every tensor comes from the same initializer
    (``frustum_convnet_tpu/models/net.py:34-35``): kaiming-normal(fan_in)
    conv weights, kaiming-uniform(fan_in) heads with zero bias, unit/zero
    BatchNorm, identity running statistics. The draws differ (``jax.random``
    against ``torch.Generator``), so the weights are held by their
    statistics: each std within 5% of ``sqrt(2 / fan_in)`` and of the other
    side's (measured: at most 4.5% from it, on a 192-entry first layer,
    and 3.5% apart), each head within ``sqrt(6 / fan_in)`` and reaching
    past 0.99 of it on both sides."""
    _cfg, spec, model = graft._flagship(tiny=False)
    b = make_batch(spec, batch=1, seed=0, with_labels=False)
    state = init_state(model, make_optimizer(TrainStepConfig()), {
        "point_cloud": jnp.asarray(b["point_cloud"]),
        "one_hot": jnp.asarray(b["one_hot"]),
        "refs": tuple(jnp.asarray(r) for r in b["refs"])}, seed=3)
    want = from_jax(jax.device_get(state.params), jax.device_get(state.batch_stats),
                    spec.num_scales)
    net = FrustumConvNet(spec)
    net.reset_parameters(torch.Generator().manual_seed(3))
    got = net.state_dict()
    assert set(got) == set(want)
    kinds = collections.Counter()
    for key, w in want.items():
        t = got[key]
        assert t.shape == w.shape and t.dtype == w.dtype, key
        owner, leaf = key.rsplit(".", 1)
        mod = net.get_submodule(owner)
        if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            fill = {"weight": 1, "bias": 0, "running_mean": 0, "running_var": 1,
                    "num_batches_tracked": 0}[leaf]
            for side in (w, t):
                assert torch.equal(side, torch.full_like(side, fill)), key
            kinds["batchnorm"] += 1
            continue
        if leaf == "bias":  # the heads' (the convolutions have none)
            assert owner in ("cls_out", "reg_out")
            for side in (w, t):
                assert torch.equal(side, torch.zeros_like(side)), key
            kinds["head bias"] += 1
            continue
        # fan_in: in-channels times taps; ConvTranspose1d stores (I, O, K)
        fan_in = (t.shape[0] * t.shape[2] if isinstance(mod, torch.nn.ConvTranspose1d)
                  else t[0].numel())
        std = (2.0 / fan_in) ** 0.5
        w_std, t_std = w.double().std().item(), t.double().std().item()
        assert abs(w_std / std - 1) < 0.05 and abs(t_std / std - 1) < 0.05, (key, w_std, t_std, std)
        assert abs(w_std / t_std - 1) < 0.05, (key, w_std, t_std)
        if owner in ("cls_out", "reg_out"):  # kaiming-uniform
            bound = (6.0 / fan_in) ** 0.5
            for side in (w, t):
                assert 0.99 * bound < side.abs().max().item() <= bound, key
            kinds["head weight"] += 1
        else:  # kaiming-normal: draws well past the uniform bound
            for side in (w, t):
                assert side.abs().max().item() > 1.5 * (6.0 / fan_in) ** 0.5, key
            kinds["conv weight"] += 1
    assert kinds == {"conv weight": 25, "head weight": 2, "head bias": 2,
                     "batchnorm": 125}, kinds


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


def test_exported_jax_init_loads_as_train_weights(tmp_path):
    """``export_jax_init``'s file restores, through the trainer's
    ``TRAIN.WEIGHTS`` path (``load_train_checkpoint``), JAX's init exactly,
    at epoch 0 and step 0, with a fresh optimizer of the run's settings."""
    tiny = ["DATA.NUM_SAMPLES", "128", "DATA.MAX_DEPTH", "16"]
    path = str(tmp_path / "jax_init.pth")
    sd = export_jax_init(path, seed=3, overrides=tiny)
    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(CFG, cfg)
    configs.merge_cfg_from_list(tiny, cfg)
    net = FrustumConvNet(configs.get_model_spec(cfg))
    net.reset_parameters(torch.Generator().manual_seed(3))
    step_cfg = _port_step_cfg(cfg)
    state = ts.TrainState(net, ts.make_optimizer(net.parameters(), step_cfg),
                          ts.multistep_lr(step_cfg))
    fresh = state.optimizer.state_dict()
    meta = checkpoints.load_train_checkpoint(path, state)
    assert meta == {"epoch": 0, "best_prec": 0.0, "best_epoch": 0} and state.step == 0
    assert state.optimizer.state_dict() == fresh
    got = net.state_dict()
    assert set(got) == set(sd) and all(torch.equal(got[k], v) for k, v in sd.items())
    # a different seed draws another init
    other = export_jax_init(str(tmp_path / "s4.pth"), seed=4, overrides=tiny)
    assert not torch.equal(other["cls_out.weight"], sd["cls_out.weight"])


if __name__ == "__main__":
    export_jax_init(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 3,
                    sys.argv[3:])
