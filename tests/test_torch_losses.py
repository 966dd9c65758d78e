"""The port's losses and training metrics against the JAX package, on the CPU.

Same numpy-seeded network outputs and labels through
``frustum_convnet_tpu_torch.models.{losses,det}`` and
``frustum_convnet_tpu/models/{losses,det}.py``: each loss primitive, then
``compute_losses`` (values, and their gradients with respect to the network
outputs) and ``_compute_metrics``, on batches with ignore labels, frustums
without foreground and a batch with no foreground at all (the normalizer
clamped at 1):

* float64 (JAX in x64): losses and output gradients within 1e-10 relative;
* float32: losses within 1e-5 relative (the backends round ``log``,
  ``exp``, ``cos`` and ``sin`` differently);
* metrics: accuracies exactly equal, IoU metrics within 1e-5 (float32) and
  1e-9 (float64), the rotated IoU's own tolerance
  (``tests/test_torch_geometry_iou.py``). ``IoU_0.7`` counts boxes at or
  above a threshold, so a box within round-off of 0.7 could count on one
  side only; the seeded batch has none there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from frustum_convnet_tpu.models import det as jdet
from frustum_convnet_tpu.models import losses as jl
from frustum_convnet_tpu_torch.models import det as tdet
from frustum_convnet_tpu_torch.models import losses as tl

torch.set_num_threads(1)

WEIGHTS = {"box": 1.0, "corner": 10.0, "head_res": 20.0, "size_res": 20.0}
DTYPES = [np.float32, np.float64]


def _jax(fn, *args, dtype):
    with jax.enable_x64(dtype == np.float64):
        conv = [jnp.asarray(a, dtype) if np.issubdtype(np.asarray(a).dtype, np.floating)
                else jnp.asarray(a) for a in args]
        out = fn(*conv)
        return jax.tree_util.tree_map(np.asarray, out)


def _t(a, dtype=None):
    a = np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.float64 if dtype == np.float64 else torch.float32) \
        if np.issubdtype(a.dtype, np.floating) else t


@pytest.mark.parametrize("dtype", DTYPES)
def test_primitives(dtype):
    rng = np.random.default_rng(0)
    err = rng.normal(0, 3, 200)
    err[:4] = [3.0, -3.0, 1.0, 0.0]  # at the huber knees and at zero
    for delta in (1.0, 3.0):
        np.testing.assert_allclose(tl.huber(_t(err, dtype), delta).numpy(),
                                   _jax(lambda e: jl.huber(e, delta), err, dtype=dtype),
                                   rtol=1e-6)
    mask = rng.random(200) > 0.5
    for denom in (None, 7.0):
        np.testing.assert_allclose(
            tl.masked_mean(_t(err, dtype), _t(mask), denom).item(),
            float(_jax(lambda v, m: jl.masked_mean(v, m, denom), err, mask, dtype=dtype)),
            rtol=1e-6)
    np.testing.assert_allclose(tl.masked_mean(_t(err, dtype), _t(mask & False)).item(), 0.0)

    logits = rng.normal(0, 2, (200, 2))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for labels in (rng.integers(-1, 2, 200), np.full(200, -1), np.zeros(200, int)):
        np.testing.assert_allclose(
            tl.softmax_focal_loss_masked(_t(probs, dtype), _t(labels)).item(),
            float(_jax(jl.softmax_focal_loss_masked, probs, labels, dtype=dtype)),
            rtol=1e-6)
    logits = rng.normal(0, 2, (200, 12))
    labels = rng.integers(0, 12, 200)
    np.testing.assert_allclose(
        tl.cross_entropy_masked(_t(logits, dtype), _t(labels), _t(mask)).item(),
        float(_jax(jl.cross_entropy_masked, logits, labels, mask, dtype=dtype)),
        rtol=1e-6)


def _outputs_and_labels(spec, b, seed, no_fg=False):
    """Network outputs near a trained model's scale, and labels: frustum 0
    all-ignore, frustum 1 all-background, the rest mixed (or no foreground
    anywhere)."""
    rng = np.random.default_rng(seed)
    L = spec.num_out
    cls_logits = rng.normal(0, 2, (b, L, 2))
    reg = rng.normal(0, 0.5, (b, L, spec.reg_size))
    ref2 = np.stack([rng.uniform(-1, 1, (b, L)), rng.uniform(0, 2, (b, L)),
                     np.linspace(1, 60, L)[None].repeat(b, 0)], axis=-1)
    centers = ref2[:, L // 2] + rng.normal(0, 0.5, (b, 3))
    # predicted centers close to the gt, so some boxes pass IoU 0.7
    reg[..., :3] = centers[:, None] - ref2 + rng.normal(0, 0.05, (b, L, 3))
    # heading and size scores pick the gt bin and class with residuals near
    # the gt for every frustum but frustum 2 (random), so the IoU metrics
    # see boxes on both sides of the threshold
    heading = rng.uniform(-np.pi, np.pi, b)
    nb, pc = spec.num_bins, 2 * np.pi / spec.num_bins
    shifted = (np.mod(heading, 2 * np.pi) + pc / 2) % (2 * np.pi)
    hbin = np.floor(shifted / pc).astype(int)
    hres = (shifted - (hbin * pc + pc / 2)) / (pc / 2)
    size = np.asarray(spec.mean_sizes)[0] * rng.uniform(0.9, 1.1, (b, 3))
    for i in range(b):
        if i == 2:
            continue
        reg[i, :, 3 + hbin[i]] += 6.0
        reg[i, :, 3 + nb + hbin[i]] = hres[i] + rng.normal(0, 0.02, L)
        reg[i, :, 3 + 2 * nb] += 6.0
        s0 = 3 + 2 * nb + spec.num_sizes
        reg[i, :, s0:s0 + 3] = (size[i] / np.asarray(spec.mean_sizes)[0] - 1
                                + rng.normal(0, 0.02, (L, 3)))
    cls_label = rng.integers(-1, 2, (b, L))
    cls_label[0] = -1
    cls_label[1] = 0
    if no_fg:
        cls_label[cls_label == 1] = 0
    labels = {
        "cls_label": cls_label,
        "box3d_center": centers,
        "box3d_heading": heading,
        "box3d_size": size,
        "size_class": np.zeros(b, np.int64),
    }
    return cls_logits, reg, ref2, labels


def _run_jax(spec, outs, dtype, grads):
    cls_logits, reg, ref2, labels = outs
    with jax.enable_x64(dtype == np.float64):
        cast = lambda a: (jnp.asarray(a, dtype)
                          if np.issubdtype(np.asarray(a).dtype, np.floating)
                          else jnp.asarray(a))
        lab = {k: cast(v) for k, v in labels.items()}

        def f(c, r):
            return jdet.compute_losses(spec, c, r, cast(ref2), lab, WEIGHTS, 0.7)

        losses, metrics = jax.jit(f)(cast(cls_logits), cast(reg))
        out = {k: float(v) for k, v in {**losses, **metrics}.items()}
        if grads:
            g = jax.jit(jax.grad(lambda c, r: f(c, r)[0]["total_loss"],
                                 argnums=(0, 1)))(cast(cls_logits), cast(reg))
            return out, [np.asarray(x) for x in g]
        return out, None


def _run_torch(spec, outs, dtype, grads):
    cls_logits, reg, ref2, labels = outs
    c = _t(cls_logits, dtype).requires_grad_(grads)
    r = _t(reg, dtype).requires_grad_(grads)
    losses, metrics = tdet.compute_losses(
        spec, c, r, _t(ref2, dtype), {k: _t(v, dtype) for k, v in labels.items()},
        WEIGHTS, 0.7)
    assert set(losses) == set(tdet.LOSS_KEYS)
    assert set(metrics) == set(tdet.metric_keys(0.7))
    assert all(not m.requires_grad for m in metrics.values())
    out = {k: v.item() for k, v in {**losses, **metrics}.items()}
    if grads:
        losses["total_loss"].backward()
        return out, [c.grad.numpy(), r.grad.numpy()]
    return out, None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("no_fg", [False, True], ids=["mixed", "no_fg"])
def test_compute_losses_and_metrics(dtype, no_fg):
    _cfg, spec, _ = graft._flagship(tiny=True)
    outs = _outputs_and_labels(spec, 4, seed=1, no_fg=no_fg)
    f64 = dtype == np.float64
    want, want_g = _run_jax(spec, outs, dtype, grads=f64)
    got, got_g = _run_torch(spec, outs, dtype, grads=f64)
    rtol = 1e-10 if f64 else 1e-5
    for k in tdet.LOSS_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-12, err_msg=k)
    for k in ("cls_acc", "head_acc", "size_acc"):
        assert got[k] == pytest.approx(want[k], rel=1e-7), k
    for k in ("IoU_2D", "IoU_3D", "IoU_0.7"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-9 if f64 else 1e-5,
                                   err_msg=k)
    if no_fg:
        assert got["center_loss"] == 0.0 and got["cls_loss"] > 0.0
    else:
        assert got["IoU_0.7"] > 0.0  # boxes on both sides of the threshold
    if f64:
        for g, w in zip(got_g, want_g):
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)


def test_losses_of_the_train_forward_with_tied_slots():
    """The flagship-shaped tiny model in train mode, through both
    frameworks in float64: the forward's tied pool slots (first-hit fill of
    sparse sections) and ignore/background rows, then every loss."""
    from frustum_convnet_tpu.data.fixtures import make_batch
    from frustum_convnet_tpu.models.net import FrustumConvNet as JaxNet
    from frustum_convnet_tpu_torch.models.net import FrustumConvNet
    from frustum_convnet_tpu_torch.models.weights import from_jax
    from frustum_convnet_tpu_torch.ops.query_depth_point import group_depth_point_multi
    from frustum_convnet_tpu_torch.parallel import train_step as ts

    _cfg, spec, _ = graft._flagship(tiny=True)
    batch = make_batch(spec, batch=3, seed=4, with_labels=True)
    batch["cls_label"] = batch["cls_label"].copy()
    batch["cls_label"][0] = -1
    groups = group_depth_point_multi(torch.from_numpy(batch["point_cloud"]),
                                     [torch.from_numpy(r) for r in batch["refs"]],
                                     spec.height_half, spec.nsamples)
    assert any(((c > 0) & (c < k)).any() for (_, c), k in zip(groups, spec.nsamples))

    with jax.enable_x64():
        jm = JaxNet(spec, dtype=jnp.float64)
        cast = lambda a: (jnp.asarray(a, jnp.float64)
                          if np.issubdtype(np.asarray(a).dtype, np.floating)
                          else jnp.asarray(a))
        b = {k: (tuple(cast(r) for r in v) if k == "refs" else cast(v))
             for k, v in batch.items() if k in ts.BATCH_KEYS}
        v = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(3), *a, train=False))(
            b["point_cloud"], b["one_hot"], list(b["refs"]))

        @jax.jit
        def losses(v, b):
            (cls, reg), _ = jm.apply(v, b["point_cloud"], b["one_hot"],
                                     list(b["refs"]), train=True,
                                     mutable=["batch_stats"])
            return jdet.compute_losses(spec, cls, reg, b["refs"][1],
                                       {k: b[k] for k in ts.LABEL_KEYS}, WEIGHTS)[0]

        want = {k: float(x) for k, x in losses(v, b).items()}
        params, stats = jax.device_get((v["params"], v["batch_stats"]))

    model = FrustumConvNet(spec).double()
    model.load_state_dict(from_jax(params, stats, spec.num_scales, dtype=torch.float64))
    cfg = ts.TrainStepConfig(loss_weights=WEIGHTS)
    got, metrics = ts.loss_and_grads(model, spec, cfg,
                                     ts.to_device(batch, "cpu", torch.float64))
    for k, x in want.items():
        np.testing.assert_allclose(float(got[k]), x, rtol=1e-10, err_msg=k)
    assert all(torch.isfinite(m) for m in metrics.values())
