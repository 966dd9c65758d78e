"""The port's half-precision compute on the CPU against the JAX package.

The tiny flagship of ``__graft_entry__._flagship(tiny=True)``, a Flax init
with perturbed BatchNorm statistics carried over by ``models.weights.from_jax``
and seeded numpy batches go through both packages at the same dtypes:
bfloat16, float16, and bfloat16 with a float32 trunk (``TPU.TRUNK_DTYPE``).

The two packages cast at the same places, but they sum in other orders, so
a half-precision value can round the other way; that noise is of the size
half precision itself adds. The bound is therefore scale-free: the relative
L2 distance from the port to JAX is at most the distance from JAX at the
half dtype to JAX in float32 (``_bound``), for each head output of the eval
forward, for the vector of a train step's eight losses and for its
gradient over all leaves together, and for each running statistic after
the step. Measured, as ratios of the distance to the bound (bfloat16,
float16, bfloat16 with a float32 trunk):

* eval forward (cls, reg): 0.12 and 0.10, 0.49 and 0.43, 0.0002 and
  0.0003;
* losses: 0.42, 0.35, 0.34; gradients over all leaves: 0.59, 0.47, 0.41;
  the worst running statistic: 0.53, 0.58, 0.23.

One leaf alone is noisier: the train-mode pool routes each gradient to the
first slot of a section's maximum, and a half-precision near-tie flips it
in either package independently, so two independent roundings of one size
sit up to sqrt(2) apart. Each leaf is held within 2x its own bound
(measured worst 0.97, 1.32 and 0.76).

Every parameter, running statistic and Adam moment stays float32 through a
step. ``_F16DenseDot`` is held to the JAX ``_f16_dense_dot`` (values and
gradients; dW finite where a plain float16 dW overflows), and the heads'
bias gradients are float32 under a float16 trunk.
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
from frustum_convnet_tpu.models.net import _f16_dense_dot
from frustum_convnet_tpu_torch.models.net import FrustumConvNet, _F16DenseDot
from frustum_convnet_tpu_torch.models.weights import from_jax
from frustum_convnet_tpu_torch.parallel import train_step as ts
from test_torch_train_step import LABEL_KEYS, WEIGHTS, _edge_batch, _jax_batch, _variables

torch.set_num_threads(1)

# (name, JAX dtype, JAX trunk dtype, port dtype, port trunk dtype)
MODES = [("bf16", jnp.bfloat16, None, torch.bfloat16, None),
         ("f16", jnp.float16, None, torch.float16, None),
         ("bf16_trunk_f32", jnp.bfloat16, jnp.float32, torch.bfloat16, torch.float32)]
IDS = [m[0] for m in MODES]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bound(port, jax_half, jax_f32) -> tuple:
    """(port to JAX, JAX half to JAX float32), relative L2."""
    return _rel(port, jax_half), _rel(jax_half, jax_f32)


@pytest.fixture(scope="module")
def tiny():
    _cfg, spec, _ = graft._flagship(tiny=True)
    batch = _edge_batch(spec, 4, 6)
    params, stats = _variables(spec, batch)
    return spec, batch, params, stats


def _port_model(spec, params, stats, dtype, trunk):
    model = FrustumConvNet(spec, dtype=dtype, trunk_dtype=trunk)
    model.load_state_dict(from_jax(params, stats, spec.num_scales), strict=True)
    return model


def _jax_forward(spec, params, stats, batch, dtype, trunk=None):
    model = JaxNet(spec, dtype=dtype, trunk_dtype=trunk)
    out = model.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(batch["point_cloud"]), jnp.asarray(batch["one_hot"]),
                      [jnp.asarray(r) for r in batch["refs"]], train=False)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_half_forward_matches_jax(tiny, mode):
    spec, batch, params, stats = tiny
    _, jdt, jtd, tdt, ttd = mode
    want = _jax_forward(spec, params, stats, batch, jdt, jtd)
    f32 = _jax_forward(spec, params, stats, batch, jnp.float32)
    model = _port_model(spec, params, stats, tdt, ttd).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(batch["point_cloud"]),
                    torch.from_numpy(batch["one_hot"]),
                    [torch.from_numpy(r) for r in batch["refs"]])
    for g, w, w32, name in zip(got, want, f32, ("cls_logits", "reg")):
        assert g.dtype == torch.float32 and w.dtype == np.float32, name
        assert torch.isfinite(g).all(), name
        dist, bound = _bound(g.numpy(), w, w32)
        assert 0 < bound and dist <= bound, (name, dist, bound)


def _jax_step(spec, params, stats, batch, dtype, trunk=None):
    """(losses, gradients and new running statistics as a port state dict)."""
    model = JaxNet(spec, dtype=dtype, trunk_dtype=trunk)
    b = _jax_batch(batch, jnp.float32)

    def loss_fn(p):
        (cls, reg), new = model.apply(
            {"params": p, "batch_stats": stats}, b["point_cloud"], b["one_hot"],
            list(b["refs"]), train=True, mutable=["batch_stats"])
        losses, _ = jax_losses(spec, cls, reg, b["refs"][1],
                               {k: b[k] for k in LABEL_KEYS}, WEIGHTS,
                               compute_metrics=False)
        return losses["total_loss"], (losses, new["batch_stats"])

    grads, (losses, new_stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    grads, new_stats = jax.device_get((grads, new_stats))
    return ({k: float(v) for k, v in losses.items()},
            from_jax(grads, new_stats, spec.num_scales, dtype=torch.float64))


@pytest.fixture(scope="module")
def jax_f32_step(tiny):
    spec, batch, params, stats = tiny
    return _jax_step(spec, params, stats, batch, jnp.float32)


@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_half_train_step_matches_jax(tiny, jax_f32_step, mode):
    spec, batch, params, stats = tiny
    _, jdt, jtd, tdt, ttd = mode
    want_losses, want = _jax_step(spec, params, stats, batch, jdt, jtd)
    f32_losses, f32 = jax_f32_step

    model = _port_model(spec, params, stats, tdt, ttd)
    cfg = ts.TrainStepConfig(loss_weights=WEIGHTS, compute_metrics=False)
    state = ts.TrainState(model, ts.make_optimizer(model.parameters(), cfg),
                          ts.multistep_lr(cfg))
    losses, _ = ts.loss_and_grads(model, spec, cfg, ts.to_device(batch, "cpu"))
    grads = {n: p.grad.detach().double() for n, p in model.named_parameters()}
    assert sorted(losses) == sorted(want_losses) and len(losses) == 8
    keys = sorted(losses)
    dist, bound = _bound([losses[k].item() for k in keys], [want_losses[k] for k in keys],
                         [f32_losses[k] for k in keys])
    assert all(losses[k].dtype == torch.float32 for k in keys)
    assert np.isfinite([losses[k].item() for k in keys]).all()
    assert dist <= bound, ("losses", dist, bound)

    names = sorted(grads)
    flat = [torch.cat([d[n].reshape(-1) for n in names]).numpy()
            for d in (grads, want, f32)]
    dist, bound = _bound(*flat)
    assert np.isfinite(flat[0]).all() and dist <= bound, ("gradient", dist, bound)
    for n in names:
        dist, bound = _bound(grads[n].numpy(), want[n].numpy(), f32[n].numpy())
        assert dist <= 2 * bound, (n, dist, bound)
    sd = model.state_dict()
    for n in sd:
        if ".running_" in n:  # one update, from float32 statistics
            dist, bound = _bound(sd[n].double().numpy(), want[n].numpy(), f32[n].numpy())
            assert dist <= bound, (n, dist, bound)

    ts.apply_update(state)
    assert all(t.dtype == torch.float32 for t in model.state_dict().values()
               if t.is_floating_point())
    assert all(v.dtype == torch.float32 for s in state.optimizer.state.values()
               for k, v in s.items() if k != "step")


def test_state_dict_is_the_same_in_every_dtype(tiny):
    """A bfloat16- or float16-trained model saves the float32 layout, and
    its weights serve at float32, and the reverse."""
    spec, batch, params, stats = tiny
    base = _port_model(spec, params, stats, None, None).state_dict()
    for dtype, trunk in ((torch.bfloat16, None), (torch.float16, torch.float32)):
        model = _port_model(spec, params, stats, dtype, trunk)
        sd = model.state_dict()
        assert list(sd) == list(base)
        assert all(sd[k].dtype == v.dtype and torch.equal(sd[k], v) for k, v in base.items())
        served = FrustumConvNet(spec)
        served.load_state_dict(sd, strict=True)
        back = FrustumConvNet(spec, dtype=dtype, trunk_dtype=trunk)
        back.load_state_dict(served.state_dict(), strict=True)


def test_f16_dot_matches_jax():
    """Values, dx and dW of ``_F16DenseDot`` against the JAX
    ``_f16_dense_dot`` on the same float16 inputs and float32 weight (the
    port's weight is the JAX kernel transposed): y within one float16 ulp
    (more than 99% bit for bit), dx within a few float16 ulps, dW (float32 sums of exact products) within 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 64, 32)).astype(np.float16)
    w = rng.normal(size=(32, 16)).astype(np.float32)  # JAX (I, O)
    g = rng.normal(size=(3, 64, 16)).astype(np.float16)

    y_j, vjp = jax.vjp(_f16_dense_dot, jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    y = _F16DenseDot.apply(tx, tw)
    y.backward(torch.from_numpy(g))
    assert y.dtype == tx.grad.dtype == torch.float16 and tw.grad.dtype == torch.float32
    y, y_j = y.detach().numpy().astype(np.float32), np.asarray(y_j, np.float32)
    assert np.mean(y == y_j) > 0.99  # the rest one float16 ulp apart
    np.testing.assert_allclose(y, y_j, rtol=2 ** -10, atol=0)
    np.testing.assert_allclose(tx.grad.numpy().astype(np.float32),
                               np.asarray(dx_j, np.float32), rtol=5e-3, atol=2e-2)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(dw_j), rtol=1e-5, atol=1e-5)
    xf, gf = x.reshape(-1, 32).astype(np.float64), g.reshape(-1, 16).astype(np.float64)
    np.testing.assert_allclose(tw.grad.numpy(), gf.T @ xf, rtol=1e-5, atol=1e-5)


def test_f16_dot_dw_does_not_overflow():
    """Same-sign products whose sum (131072) exceeds float16's 65504, as in
    ``tests/test_float16.py:47``: a plain float16 dW is inf, the guarded
    dot's float32 dW is exact, as JAX's is."""
    rows = 1 << 16
    x = torch.full((rows, 8), 2.0, dtype=torch.float16, requires_grad=True)
    w = torch.zeros((4, 8), dtype=torch.float32, requires_grad=True)
    g = torch.ones((rows, 4), dtype=torch.float16)
    _F16DenseDot.apply(x, w).backward(g)
    assert w.grad.dtype == torch.float32 and torch.all(w.grad == 2.0 * rows)
    assert torch.isinf(g.T @ x.detach()).all()  # the plain float16 dW
    _, vjp = jax.vjp(_f16_dense_dot, jnp.full((rows, 8), 2.0, jnp.float16),
                     jnp.zeros((8, 4), jnp.float32))
    np.testing.assert_array_equal(np.asarray(vjp(jnp.ones((rows, 4), jnp.float16))[1]),
                                  w.grad.numpy().T)


def test_f16_head_gradients_stay_float32():
    """Under a float16 trunk the heads take the guarded dot with a float32
    bias: their outputs and bias gradients are float32, and an
    overflow-scale cotangent (``tests/test_float16.py:133``) leaves every
    head gradient finite."""
    _cfg, spec, _ = graft._flagship(tiny=True)
    b = make_batch(spec, batch=4, seed=0, with_labels=False)
    model = FrustumConvNet(spec, dtype=torch.float16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    cls, reg = model(torch.from_numpy(b["point_cloud"]), torch.from_numpy(b["one_hot"]),
                     [torch.from_numpy(r) for r in b["refs"]])
    assert cls.dtype == reg.dtype == torch.float32
    ((cls * 1e4).sum() + (reg * 1e4).sum()).backward()
    for head in (model.cls_out, model.reg_out):
        assert head.bias.grad.dtype == head.weight.grad.dtype == torch.float32
        assert torch.isfinite(head.bias.grad).all() and torch.isfinite(head.weight.grad).all()
