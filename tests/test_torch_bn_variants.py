"""The port's BatchNorm and remat variants on the CPU against the JAX package.

``cfg.TPU.BN_GROUP_SIZE`` (ghost BatchNorm at every BatchNorm),
``FAST_BN`` and ``FAST_BN_FIRST`` (analytic statistics in the PointNet
Denses) and ``REMAT_POINTNET`` (rematerialized PointNet scales), alone and
combined, in float64 on both sides (JAX with x64), at the tiny flagship of
``__graft_entry__._flagship(tiny=True)`` with a Flax init carried over by
``models.weights.from_jax`` and a seeded batch of 4 (ghost groups of 2):
the train-mode outputs, the eight losses, every gradient leaf and every
running statistic after the step agree within 1e-10 of each tensor's
largest magnitude. Ghost BatchNorm with FAST_BN keeps the ghost statistics,
as in JAX.

In the port itself, REMAT leaves the outputs, every gradient and every
running statistic bit-identical to no REMAT (float32 and bfloat16): the
backward recomputes each scale, and the recompute updates no statistic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from frustum_convnet_tpu.models.det import compute_losses as jax_losses
from frustum_convnet_tpu.models.net import FrustumConvNet as JaxNet
from frustum_convnet_tpu_torch.models.net import DenseBNReLU, FrustumConvNet
from frustum_convnet_tpu_torch.models.weights import from_jax
from frustum_convnet_tpu_torch.parallel import train_step as ts
from test_torch_train_step import LABEL_KEYS, WEIGHTS, _edge_batch, _jax_batch, _jcast, _variables

torch.set_num_threads(1)

VARIANTS = {
    "ghost": dict(bn_group=2),
    "fast_bn": dict(fast_bn=True),
    "fast_bn_first": dict(fast_bn_first=True),
    "remat": dict(remat_pointnet=True),
    "ghost_fast_bn": dict(bn_group=2, fast_bn=True),
    "remat_fast_bn_first_ghost": dict(remat_pointnet=True, fast_bn_first=True, bn_group=2),
}
TOL = 1e-10


@pytest.fixture(scope="module")
def tiny():
    _cfg, spec, _ = graft._flagship(tiny=True)
    batch = _edge_batch(spec, 4, 6)
    params, stats = _variables(spec, batch)
    return spec, batch, params, stats


def _jax_step(spec, params, stats, batch, variant):
    with jax.enable_x64():
        cast = _jcast(jnp.float64)
        model = JaxNet(spec, dtype=jnp.float64, **variant)
        b = _jax_batch(batch, jnp.float64)
        s = jax.tree_util.tree_map(cast, stats)

        def loss_fn(p):
            (cls, reg), new = model.apply(
                {"params": p, "batch_stats": s}, b["point_cloud"], b["one_hot"],
                list(b["refs"]), train=True, mutable=["batch_stats"])
            losses, _ = jax_losses(spec, cls, reg, b["refs"][1],
                                   {k: b[k] for k in LABEL_KEYS}, WEIGHTS,
                                   compute_metrics=False)
            return losses["total_loss"], (losses, new["batch_stats"], cls, reg)

        grads, (losses, new_stats, cls, reg) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(cast, params))
        grads, new_stats, cls, reg = jax.device_get((grads, new_stats, cls, reg))
        return ({k: float(v) for k, v in losses.items()}, np.asarray(cls), np.asarray(reg),
                from_jax(grads, new_stats, spec.num_scales, dtype=torch.float64))


class _Outputs(FrustumConvNet):
    """Keeps its last outputs."""

    def forward(self, *args):
        self.last = super().forward(*args)
        return self.last


def _port_step(spec, params, stats, batch, variant, dtype=torch.float64, compute=None):
    model = _Outputs(spec, dtype=compute, **variant).to(dtype)
    model.load_state_dict(from_jax(params, stats, spec.num_scales, dtype=dtype), strict=True)
    cfg = ts.TrainStepConfig(loss_weights=WEIGHTS, compute_metrics=False)
    fdt = torch.float64 if dtype == torch.float64 else torch.float32
    losses, _ = ts.loss_and_grads(model, spec, cfg, ts.to_device(batch, "cpu", fdt))
    return model, {k: v.item() for k, v in losses.items()}


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(np.abs(want).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_matches_jax_f64(tiny, name):
    spec, batch, params, stats = tiny
    variant = VARIANTS[name]
    want_losses, want_cls, want_reg, want = _jax_step(spec, params, stats, batch, variant)
    model, losses = _port_step(spec, params, stats, batch, variant)
    _close(model.last[0].detach(), want_cls, "cls_logits")
    _close(model.last[1].detach(), want_reg, "reg")
    assert sorted(losses) == sorted(want_losses)
    _close([losses[k] for k in sorted(losses)],
           [want_losses[k] for k in sorted(losses)], "losses")
    for n, p in model.named_parameters():
        _close(p.grad, want[n], n)
    for n, v in model.state_dict().items():
        if ".running_" in n:
            _close(v, want[n], n)
    # the statistics moved: the step used the variant's batch statistics
    base = from_jax(params, stats, spec.num_scales, dtype=torch.float64)
    assert not torch.equal(model.state_dict()["conv_net.block2_merge.1.running_var"],
                           base["conv_net.block2_merge.1.running_var"])


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", [{}, dict(fast_bn_first=True, bn_group=2)],
                         ids=["plain", "fast_first_ghost"])
def test_remat_is_bit_identical_in_the_port(tiny, dtype, variant):
    """REMAT against no REMAT in the port: identical outputs, gradients and
    running statistics, with the MLPs run twice (forward and recompute)
    and the running statistics updated once."""
    spec, batch, params, stats = tiny
    runs = []
    for remat in (False, True):
        calls = []
        hook = torch.nn.modules.module.register_module_forward_hook(
            lambda mod, args, out: calls.append(mod) if isinstance(mod, DenseBNReLU) else None)
        try:
            model, losses = _port_step(spec, params, stats, batch,
                                       dict(variant, remat_pointnet=remat),
                                       dtype=torch.float32, compute=dtype)
        finally:
            hook.remove()
        runs.append((model, losses, len(calls)))
    (plain, l0, n0), (remat, l1, n1) = runs
    assert n0 == 3 * spec.num_scales and n1 == 2 * n0
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(plain.last, remat.last))
    grads = dict(remat.named_parameters())
    for n, p in plain.named_parameters():
        assert torch.equal(p.grad, grads[n].grad), n
    sd = remat.state_dict()
    for n, v in plain.state_dict().items():
        assert torch.equal(v, sd[n]), n


def test_ghost_bn_needs_a_divisible_batch_and_only_trains(tiny):
    spec, batch, params, stats = tiny
    with pytest.raises(ValueError, match="not divisible by BN group 3"):
        _port_step(spec, params, stats, batch, dict(bn_group=3))
    ghost, plain = (FrustumConvNet(spec, bn_group=g) for g in (3, 0))
    for m in (ghost, plain):
        m.load_state_dict(from_jax(params, stats, spec.num_scales), strict=True)
        m.eval()
    args = (torch.from_numpy(batch["point_cloud"]), torch.from_numpy(batch["one_hot"]),
            [torch.from_numpy(r) for r in batch["refs"]])
    with torch.no_grad():  # eval mode normalizes with the running statistics
        assert all(torch.equal(a, b) for a, b in zip(ghost(*args), plain(*args)))
