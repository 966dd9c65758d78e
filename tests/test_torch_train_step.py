"""The port's train step on the CPU against the JAX train step.

Same numpy-seeded batches and the same weights (the Flax init with perturbed
BatchNorm running statistics, carried over with ``models.weights.from_jax``;
gradients come back through the same transform) through both frameworks:

* per-leaf gradients of the total loss (train-mode BatchNorm, first-slot
  pool routing, dense-masked losses) against ``jax.grad`` of the JAX loss,
  with the running statistics after the step:
  - float64 at the tiny shape (a batch with an all-ignore and an
    all-background frustum) and at flagship width, where round-off is
    ~1e-13 of a leaf's magnitude: rtol 1e-7, atol 1e-9 of the leaf's max;
  - float32 at flagship width, batch 2, where the JAX gradient itself lies
    up to 1.4% (relative L2 norm of a leaf; measured over five seeds) from
    its float64 value: its batch variance is ``mean2 - mean^2``, which
    cancels in float32. The port's two-pass ``var_mean`` stays within
    4e-4 of float64. So each leaf agrees with JAX's float32 gradient within
    3%, all together within 1%, and each leaf with JAX's float64 gradient
    within 2e-3;
* a 15-step float64 trajectory against ``build_train_step`` +
  ``make_optimizer``, on the pattern of ``tests/test_grad_parity.py:269``,
  with the learning rate decaying twice, reaching the MIN_LR floor, and the
  schedule count reset after step 10 (the fine-tune quirk);
* ``multistep_lr`` at the milestones, the floor and the warmup.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from frustum_convnet_tpu.data.fixtures import make_batch
from frustum_convnet_tpu.models.det import compute_losses as jax_losses
from frustum_convnet_tpu.models.net import FrustumConvNet as JaxNet
from frustum_convnet_tpu.parallel import train_step as jts
from frustum_convnet_tpu_torch.models.net import FrustumConvNet
from frustum_convnet_tpu_torch.models.weights import from_jax
from frustum_convnet_tpu_torch.parallel import train_step as ts

torch.set_num_threads(1)

WEIGHTS = {"box": 1.0, "corner": 10.0, "head_res": 20.0, "size_res": 20.0}
LABEL_KEYS = ("cls_label", "box3d_center", "box3d_heading", "box3d_size",
              "size_class")


def _variables(spec, batch, seed=0):
    """Flax init (seed 3) with BatchNorm running stats moved off identity,
    as numpy trees."""
    model = JaxNet(spec)
    init = jax.jit(lambda *a: model.init(jax.random.PRNGKey(3), *a, train=False))
    v = init(jnp.asarray(batch["point_cloud"]), jnp.asarray(batch["one_hot"]),
             [jnp.asarray(r) for r in batch["refs"]])
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, v["params"])

    def perturb(path, x):
        x = np.asarray(x)
        if path[-1].key == "mean":
            return (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
        return (x * rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)

    return params, jax.tree_util.tree_map_with_path(perturb, v["batch_stats"])


def _edge_batch(spec, batch, seed):
    """Labeled fixture batch; with 4 frustums, item 0 is all-ignore and
    item 1 all-background (the fg normalizer comes from the others)."""
    b = make_batch(spec, batch=batch, seed=seed, with_labels=True)
    b["cls_label"] = b["cls_label"].copy()
    if batch >= 4:
        b["cls_label"][0] = -1
        b["cls_label"][1] = 0
    assert (b["cls_label"] == 1).any()
    return b


def _jcast(dtype):
    return lambda a: jnp.asarray(
        a, dtype if np.issubdtype(np.asarray(a).dtype, np.floating) else None)


def _jax_batch(batch, dtype):
    cast = _jcast(dtype)
    return {k: (tuple(cast(r) for r in v) if k == "refs" else cast(v))
            for k, v in batch.items() if k in ts.BATCH_KEYS}


def _torch_model(spec, params, stats, dtype):
    model = FrustumConvNet(spec).to(dtype)
    model.load_state_dict(from_jax(params, stats, spec.num_scales, dtype=dtype),
                          strict=True)
    return model


def _jax_grads(spec, params, stats, batch, f64):
    """(losses, gradients and new running stats as a port state dict)."""
    dtype = jnp.float64 if f64 else jnp.float32
    with jax.enable_x64(f64):
        cast = _jcast(dtype)
        model = JaxNet(spec, dtype=dtype)
        b = _jax_batch(batch, dtype)
        p = jax.tree_util.tree_map(cast, params)
        s = jax.tree_util.tree_map(cast, stats)

        def loss_fn(p):
            (cls, reg), new = model.apply(
                {"params": p, "batch_stats": s}, b["point_cloud"], b["one_hot"],
                list(b["refs"]), train=True, mutable=["batch_stats"])
            losses, _ = jax_losses(spec, cls, reg, b["refs"][1],
                                   {k: b[k] for k in LABEL_KEYS}, WEIGHTS,
                                   compute_metrics=False)
            return losses["total_loss"], (losses, new["batch_stats"])

        grads, (losses, new_stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(p)
        grads, new_stats = jax.device_get((grads, new_stats))
        losses = {k: float(v) for k, v in losses.items()}
    tdt = torch.float64 if f64 else torch.float32
    return losses, from_jax(grads, new_stats, spec.num_scales, dtype=tdt)


def _torch_grads(spec, params, stats, batch, f64):
    dtype = torch.float64 if f64 else torch.float32
    model = _torch_model(spec, params, stats, dtype)
    cfg = ts.TrainStepConfig(loss_weights=WEIGHTS, compute_metrics=False)
    losses, _ = ts.loss_and_grads(model, spec, cfg,
                                  ts.to_device(batch, "cpu", dtype))
    grads = {n: p.grad for n, p in model.named_parameters()}
    return {k: float(v) for k, v in losses.items()}, grads, model.state_dict()


def _compare(tiny, batch_size, seed, f64):
    _cfg, spec, _ = graft._flagship(tiny=tiny)
    batch = _edge_batch(spec, batch_size, seed)
    params, stats = _variables(spec, batch)
    want_losses, want = _jax_grads(spec, params, stats, batch, f64)
    got_losses, grads, sd = _torch_grads(spec, params, stats, batch, f64)
    return spec, want_losses, want, got_losses, grads, sd


@pytest.mark.parametrize("tiny,batch_size,seed", [(True, 4, 6), (False, 2, 9)],
                         ids=["tiny_b4_edge_items", "flagship_b2"])
def test_grads_match_jax_f64(tiny, batch_size, seed):
    _spec, want_losses, want, got_losses, grads, sd = _compare(
        tiny, batch_size, seed, f64=True)
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k], v, rtol=1e-10, err_msg=k)
    for name, g in grads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-7,
                                   atol=1e-9 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)
    for name, v in sd.items():
        if ".running_" in name:  # one BatchNorm update, Bessel-corrected var
            np.testing.assert_allclose(v.numpy(), want[name].numpy(),
                                       rtol=1e-9, atol=1e-12, err_msg=name)


def test_grads_match_jax_f64_on_a_difficulty_mix_batch(tmp_path):
    """The same float64 comparison on a batch the port's provider draws from
    the protocol's difficulty mix (its ``build_dataset`` at 8 frames, the
    tiny model's cfg): occluded, truncated and sparse cars give frustums of
    few points and clipped boxes, which the fixtures above do not."""
    from frustum_convnet_tpu_torch import configs
    from frustum_convnet_tpu_torch.data.provider import FrustumProvider
    from frustum_convnet_tpu_torch.engine.loader import BatchLoader
    from frustum_convnet_tpu_torch.models.registry import get_model_spec
    from frustum_convnet_tpu_torch.tools.run_synth_protocol import build_dataset

    _, pickles = build_dataset(8, 2, str(tmp_path), 1, difficulty_mix=True)
    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file("cfgs/det_sample.yaml", cfg)
    configs.merge_cfg_from_list(
        ["DATA.DATA_ROOT", pickles, "DATA.MAX_DEPTH", "48", "DATA.NUM_SAMPLES", "128",
         "DATA.STRIDE", "(1.0, 2.0, 4.0, 8.0)", "DATA.HEIGHT_HALF", "(1.0, 2.0, 4.0, 8.0)"],
        cfg)
    spec = get_model_spec(cfg)
    loader = BatchLoader(FrustumProvider(cfg, "train"), 16, spec.num_scales,
                         shuffle=False, drop_last=True)
    batch = next(iter(loader.epoch(0)))
    assert (batch["cls_label"] == 1).any() and (batch["cls_label"] == 0).any()
    params, stats = _variables(spec, batch)
    want_losses, want = _jax_grads(spec, params, stats, batch, f64=True)
    got_losses, grads, sd = _torch_grads(spec, params, stats, batch, f64=True)
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k], v, rtol=1e-10, err_msg=k)
    for name, g in grads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-7,
                                   atol=1e-9 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)
    for name, v in sd.items():
        if ".running_" in name:
            np.testing.assert_allclose(v.numpy(), want[name].numpy(),
                                       rtol=1e-9, atol=1e-12, err_msg=name)


def _rel(a, b):
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


def test_grads_match_jax_f32_flagship():
    spec, want_losses, want, got_losses, grads, _sd = _compare(
        False, 2, 9, f64=False)
    assert spec.num_refs == (280, 140, 70, 35) and spec.num_out == 140
    batch = _edge_batch(spec, 2, 9)
    _, want64 = _jax_grads(spec, *_variables(spec, batch), batch, f64=True)
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k], v, rtol=1e-4, err_msg=k)
    diff2 = ref2 = 0.0
    for name, g in grads.items():
        w = want[name]
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= 3e-2, (name, _rel(g, w))
        assert _rel(g, want64[name].float()) <= 2e-3, name
        diff2 += (g - w).norm().item() ** 2
        ref2 += w.norm().item() ** 2
    assert diff2 ** 0.5 <= 1e-2 * ref2 ** 0.5


def test_train_mode_pool_routes_ties_to_first_slot():
    """Tied slots (the first-hit fill) send the whole gradient to the first
    of them, as the JAX ``slot_max_pool(train=True)`` does."""
    from frustum_convnet_tpu.models.net import slot_max_pool as jax_pool
    from frustum_convnet_tpu_torch.models.net import slot_max_pool

    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, (2, 5, 8, 4)).astype(np.float64)  # many ties
    x[:, :, 4:] = x[:, :, :1]  # first-hit fill: slots 4.. repeat slot 0
    cot = rng.normal(size=(2, 5, 4))
    t = torch.from_numpy(x).requires_grad_()
    (slot_max_pool(t, train=True) * torch.from_numpy(cot)).sum().backward()
    with jax.enable_x64():
        _, vjp = jax.vjp(lambda a: jax_pool(a, True), jnp.asarray(x))
        (want,) = vjp(jnp.asarray(cot))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    assert ((t.grad != 0).sum(dim=2) == 1).all()  # one slot per channel
    np.testing.assert_array_equal(slot_max_pool(t, train=False).detach().numpy(),
                                  x.max(axis=2))


def test_trajectory_matches_jax_f64():
    """15 Adam steps from the same weights over the same batches, with the
    schedule decaying every 4 steps (1e-3, 1e-4, then the 5e-5 floor) and
    the count reset after step 10: per-step losses, final parameters and
    final BatchNorm running statistics agree. In float64 the gradients
    differ by summation order only (~1e-13), but Adam divides each element
    by its magnitude plus eps=1e-8, so an element within ~1e-8 of zero
    turns that round-off into a visible change of its update (in float32 it
    would be ~lr-sized, ``tests/test_grad_parity.py:277-283``). Measured:
    parameters within 4e-5 lr, losses within 3.3e-8, running statistics
    within 2e-5 relative; the bounds sit 3-25x above that."""
    n_steps, reset_after = 15, 10
    _cfg, spec, _ = graft._flagship(tiny=True)
    base = [make_batch(spec, batch=4, seed=100 + i, with_labels=True)
            for i in range(3)]
    batches = [base[i % 3] for i in range(n_steps)]
    params, stats = _variables(spec, base[0])
    kw = dict(base_lr=1e-3, min_lr=5e-5, gamma=0.1, lr_steps=[1],
              warmup_epochs=0.0, steps_per_epoch=4, weight_decay=1e-4,
              optimizer="adam", momentum=0.9, loss_weights=WEIGHTS,
              iou_thresh=0.7, compute_metrics=False)

    with jax.enable_x64():
        cast = _jcast(jnp.float64)
        jcfg = jts.TrainStepConfig(**kw)
        tx = jts.make_optimizer(jcfg)
        step = jts.build_train_step(JaxNet(spec, dtype=jnp.float64), spec, tx,
                                    jcfg, mesh=None, donate=False)
        p = jax.tree_util.tree_map(cast, params)
        state = jts.TrainState(params=p,
                               batch_stats=jax.tree_util.tree_map(cast, stats),
                               opt_state=tx.init(p), step=jnp.zeros((), jnp.int32))
        want_losses = []
        for i, b in enumerate(batches):
            if i == reset_after:
                state = jts.TrainState(
                    params=state.params, batch_stats=state.batch_stats,
                    opt_state=jts.reset_schedule_count(state.opt_state),
                    step=state.step)
            state, losses, _ = step(state, _jax_batch(b, jnp.float64))
            want_losses.append(float(losses["total_loss"]))
        want = from_jax(jax.device_get(state.params),
                        jax.device_get(state.batch_stats), spec.num_scales,
                        dtype=torch.float64)

    model = _torch_model(spec, params, stats, torch.float64)
    cfg = ts.TrainStepConfig(**kw)
    tstate = ts.TrainState(model, ts.make_optimizer(model.parameters(), cfg),
                           ts.multistep_lr(cfg))
    tstep = ts.build_train_step(spec, cfg)
    got_losses, lrs = [], []
    for i, b in enumerate(batches):
        if i == reset_after:
            ts.reset_schedule_count(tstate.optimizer)
        losses, _ = tstep(tstate, ts.to_device(b, "cpu", torch.float64))
        got_losses.append(float(losses["total_loss"]))
        lrs.append(tstate.optimizer.param_groups[0]["lr"])

    np.testing.assert_allclose(lrs, [1e-3] * 4 + [1e-4] * 4 + [5e-5] * 2
                               + [1e-3] * 4 + [1e-4], rtol=1e-12)
    assert tstate.step == n_steps
    assert int(tstate.optimizer.state_dict()["state"][0]["step"]) == n_steps
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-7)
    sd = model.state_dict()
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        if ".running_" in name:
            np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
        else:  # within 1e-3 of one lr-sized step
            np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(lr_steps=[20], steps_per_epoch=10),             # periodic, flagship
    dict(lr_steps=[3, 5], steps_per_epoch=7, gamma=0.5),  # MultiStepLR
    dict(lr_steps=[2], steps_per_epoch=5, min_lr=3e-5),   # floor
    dict(lr_steps=[20], steps_per_epoch=10, warmup_epochs=1.5),
], ids=["periodic", "multistep", "floor", "warmup"])
def test_multistep_lr_matches_jax(kw):
    """The schedule at every step around the milestones, the floor and the
    end of the warmup (the JAX schedule computes in float32)."""
    cfg = dict(base_lr=1e-3, min_lr=1e-5, gamma=0.1)
    cfg.update(kw)
    ours = ts.multistep_lr(ts.TrainStepConfig(**cfg))
    theirs = jts.multistep_lr(jts.TrainStepConfig(**cfg))
    steps = range(0, 500)
    got = np.array([ours(s) for s in steps])
    want = np.array([float(theirs(jnp.asarray(s, jnp.int32))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == pytest.approx(
        cfg["base_lr"] / (cfg.get("warmup_epochs", 0) * cfg["steps_per_epoch"])
        if cfg.get("warmup_epochs") else cfg["base_lr"])
    assert len(set(np.round(got, 12))) > 2  # decays (or warms) in the window


def test_reset_schedule_count_keeps_adam_state():
    """The fine-tune quirk restarts the schedule and keeps Adam's moments
    and step counts; the counter travels in the optimizer's state dict."""
    params = [torch.nn.Parameter(torch.ones(3))]
    cfg = ts.TrainStepConfig(lr_steps=[1], steps_per_epoch=2)
    opt = ts.make_optimizer(params, cfg)
    state = ts.TrainState(torch.nn.Linear(1, 1), opt, ts.multistep_lr(cfg))
    for _ in range(3):
        params[0].grad = torch.full((3,), 0.5)
        ts.apply_update(state)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-4)
    moments = opt.state[params[0]]["exp_avg"].clone()
    saved = opt.state_dict()
    ts.reset_schedule_count(opt)
    assert opt.param_groups[0]["schedule_count"] == 0
    torch.testing.assert_close(opt.state[params[0]]["exp_avg"], moments)
    assert int(opt.state[params[0]]["step"]) == 3
    params[0].grad = torch.full((3,), 0.5)
    ts.apply_update(state)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3)

    restored = ts.make_optimizer(params, cfg)
    restored.load_state_dict(saved)
    assert restored.param_groups[0]["schedule_count"] == 3
