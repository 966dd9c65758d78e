"""Training and eval steps of the port on one device: loss, gradients, optimizer.

Counterpart of ``frustum_convnet_tpu/parallel/train_step.py`` (its module
imports optax, so ``TrainStepConfig`` is declared here again with the same
fields and defaults):

* the optimizer is ``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8,
  weight_decay=wd)``: the same coupled L2 as optax's ``add_decayed_weights``
  + ``scale_by_adam``, with eps outside the square root; SGD with
  ``momentum=m, dampening=0`` is ``optax.trace``. One param group, so the
  decay reaches every parameter, BatchNorm's and the heads' biases included,
  as in optax;
* the learning rate is ``multistep_lr`` of the port's own schedule counter,
  ``param_group["schedule_count"]``, evaluated before the counter is
  incremented, as optax's ``scale_by_learning_rate`` evaluates its schedule
  at ``count`` before ``count + 1``. It lives in the param group, so the
  optimizer's ``state_dict`` carries it as optax's state carries
  ``ScaleByScheduleState.count``, and :func:`reset_schedule_count` can restart
  the schedule while Adam's moments and step counts stay;
* BatchNorm batch statistics are the model's (``module.train()``);
* data parallelism (``parallel.mesh``): under a process group each rank
  steps on its shard of the global batch. The BatchNorm statistics and
  every loss normaliser are the global batch's (``compute_losses(psum=
  mesh.global_sum)``), so each rank's loss is its share of the global one;
  after the backward the gradients are summed over the ranks, the JAX
  ``psum``, and the returned losses and metrics are the sums of the
  shares, the global values. With no group every step is the
  single-device step, bit for bit;
* the steps compute in the model's dtypes (``FrustumConvNet.set_precision``)
  while the batch stays float32 and the losses take the heads' outputs,
  which are at least float32, as the JAX steps do with the model's
  ``dtype``.

A batch is a dict of tensors on the model's device: point_cloud (B, N, C),
one_hot (B, V), refs (tuple of (B, M_i, 3)), cls_label (B, L),
box3d_center (B, 3), box3d_heading (B,), box3d_size (B, 3), size_class (B,).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from frustum_convnet_tpu_torch.models.spec import DetModelSpec
from frustum_convnet_tpu_torch.models.det import compute_losses
from frustum_convnet_tpu_torch.parallel import mesh

BATCH_KEYS = ("point_cloud", "one_hot", "refs", "cls_label", "box3d_center",
              "box3d_heading", "box3d_size", "size_class")
LABEL_KEYS = ("cls_label", "box3d_center", "box3d_heading", "box3d_size",
              "size_class")


@dataclasses.dataclass
class TrainStepConfig:
    base_lr: float = 1e-3
    min_lr: float = 1e-5
    gamma: float = 0.1
    lr_steps: Sequence[int] = (20,)  # epoch milestones
    # linear LR warmup over the first N epochs (fractional ok); 0 reproduces
    # the reference schedule exactly
    warmup_epochs: float = 0.0
    steps_per_epoch: int = 1000
    weight_decay: float = 1e-4
    optimizer: str = "adam"  # adam | sgd
    momentum: float = 0.9
    loss_weights: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"box": 1.0, "corner": 10.0, "head_res": 20.0,
                                 "size_res": 20.0})
    iou_thresh: float = 0.7
    # False drops the rotated-IoU monitoring metrics from the step (losses
    # are still returned): the metric-free twin between metric samples
    compute_metrics: bool = True


def multistep_lr(cfg: TrainStepConfig, dtype=np.float32) -> Callable[[int], float]:
    """Reference LR schedule with MIN_LR floor, stepped per epoch.

    One milestone is the reference's StepLR with ``step_size = LR_STEPS[0]``,
    a PERIODIC decay (1e-3 -> 1e-4 @20 -> 1e-5 @40, floored at MIN_LR); more
    than one is MultiStepLR, one decay at each milestone. With
    ``warmup_epochs`` the rate is ``base_lr * (step + 1) / wsteps`` for the
    first ``wsteps`` steps.

    It computes in ``dtype``, op for op as the JAX schedule computes in
    JAX's default float type: float32, or float64 under ``jax_enable_x64``.
    So each step's rate is the JAX driver's to the bit; in double precision
    a decayed rate would lie an ulp of float32 from it (1e-3 * 0.1 rounds to
    9.99999975e-05, JAX's float32 product is 1.00000005e-04).
    """
    f = np.dtype(dtype).type
    periodic = len(cfg.lr_steps) == 1
    step_size = f(cfg.lr_steps[0]) if periodic else f(1.0)
    milestones = [f(m) for m in cfg.lr_steps]
    base_lr, gamma, min_lr = f(cfg.base_lr), f(cfg.gamma), f(cfg.min_lr)
    wsteps = f(float(cfg.warmup_epochs) * cfg.steps_per_epoch)

    def schedule(step: int) -> float:
        epoch = np.floor(f(step) / f(cfg.steps_per_epoch))
        if periodic:
            k = np.floor(epoch / step_size)
        else:
            k = f(sum(epoch >= m for m in milestones))
        lr = max(base_lr * gamma ** k, min_lr)
        if cfg.warmup_epochs > 0 and f(step) < wsteps:
            lr = base_lr * (f(step) + f(1.0)) / wsteps
        return float(lr)

    return schedule


def make_optimizer(params, cfg: TrainStepConfig) -> torch.optim.Optimizer:
    """Adam or SGD over ``params`` in one param group, with the schedule
    counter at 0 (the learning rate is set from it before every update)."""
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.base_lr, betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.base_lr, momentum=cfg.momentum,
                              dampening=0.0, weight_decay=cfg.weight_decay)
    else:
        raise ValueError(cfg.optimizer)
    for group in opt.param_groups:
        group["schedule_count"] = 0
    return opt


def reset_schedule_count(optimizer: torch.optim.Optimizer) -> None:
    """Restart the LR schedule at step 0, keeping the optimizer's moments
    and bias-correction step counts: the reference's fine-tune-from quirk
    (``train_net_det.py:99,345-361``), the counterpart of the JAX
    ``reset_schedule_count``."""
    for group in optimizer.param_groups:
        group["schedule_count"] = 0


class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer, the
    LR schedule and the global step count."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = step


def to_device(batch_np: dict, device, dtype=torch.float32) -> dict:
    """The model's inputs and labels of a collated numpy batch, as tensors
    on ``device``; floating arrays in ``dtype``."""
    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.to(device, dtype if t.is_floating_point() else None)

    return {k: (tuple(put(r) for r in batch_np[k]) if k == "refs"
                else put(batch_np[k]))
            for k in BATCH_KEYS if k in batch_np}


def _losses(model, spec: DetModelSpec, cfg: TrainStepConfig, batch,
            compute_metrics: bool, psum=None):
    refs = list(batch["refs"])
    cls_logits, reg = model(batch["point_cloud"], batch["one_hot"], refs)
    labels = {k: batch[k] for k in LABEL_KEYS}
    return compute_losses(spec, cls_logits, reg, refs[1], labels,
                          cfg.loss_weights, cfg.iou_thresh,
                          compute_metrics=compute_metrics, psum=psum)


def _psum():
    """The sum over the ranks under a process group, else None (local)."""
    return mesh.global_sum if mesh.initialized() else None


def _totals(losses: dict, metrics: dict, psum) -> tuple:
    """(losses, metrics) detached and, with ``psum``, summed over the ranks
    in one all-reduce: the ranks' shares become the global values."""
    vals = {k: v.detach() for k, v in {**losses, **metrics}.items()}
    if psum is not None and vals:
        dtype = functools.reduce(torch.promote_types, (v.dtype for v in vals.values()))
        total = psum(torch.stack([v.to(dtype) for v in vals.values()]))
        vals = {k: t.to(v.dtype) for (k, v), t in zip(vals.items(), total)}
    return ({k: vals[k] for k in losses}, {k: vals[k] for k in metrics})


def loss_and_grads(model, spec: DetModelSpec, cfg: TrainStepConfig, batch):
    """Train-mode forward and losses, then the backward of the total loss:
    each parameter's ``.grad`` holds its gradient (summed over the ranks
    under a process group) and the BatchNorm running statistics have taken
    one update. Returns (losses, metrics), detached: the global values."""
    model.train()
    for p in model.parameters():
        p.grad = None
    psum = _psum()
    losses, metrics = _losses(model, spec, cfg, batch, cfg.compute_metrics, psum)
    losses["total_loss"].backward()
    mesh.all_reduce_grads(model.parameters())
    return _totals(losses, metrics, psum)


def apply_update(state: TrainState) -> None:
    """One optimizer update at the current schedule count, then count + 1."""
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(group["schedule_count"])
        group["schedule_count"] += 1
    state.optimizer.step()
    state.step += 1


def build_train_step(spec: DetModelSpec, cfg: TrainStepConfig):
    """``step(state, batch) -> (losses, metrics)``, updating ``state``."""

    def step(state: TrainState, batch):
        losses, metrics = loss_and_grads(state.model, spec, cfg, batch)
        apply_update(state)
        return losses, metrics

    return step


def build_train_step_accum(spec: DetModelSpec, cfg: TrainStepConfig):
    """Train step with accumulation on the device.

    ``step(state, accum, batch) -> (losses, metrics)`` adds every key of
    ``accum`` from the step's losses and metrics in place, so epoch
    statistics cover every iteration without a device-to-host sync; the host
    reads ``accum`` once per epoch. A key of ``accum`` that the step does not
    produce raises (for example a metric key when ``cfg.compute_metrics`` is
    False: pass that twin only the loss keys).
    """
    inner = build_train_step(spec, cfg)

    def step(state: TrainState, accum: dict, batch):
        losses, metrics = inner(state, batch)
        vals = {**losses, **metrics}
        for k, acc in accum.items():
            acc.add_(vals[k].to(acc.dtype))
        return losses, metrics

    return step


def init_accum(keys, device) -> dict:
    """Zero-initialized float32 accumulator on ``device``."""
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in keys}


def build_eval_step(spec: DetModelSpec, cfg: TrainStepConfig, local: bool = False):
    """Validation step: forward with the running BatchNorm statistics, then
    losses and metrics, no gradients. ``step(state, batch) -> (losses,
    metrics)``: under a process group, the global values over the ranks'
    shards of a batch. ``local`` runs no collective: the loader's short
    global tail, which every rank evaluates whole (JAX ``engine/train.py``
    runs it unsharded)."""

    def step(state: TrainState, batch):
        state.model.eval()
        psum = None if local else _psum()
        with torch.no_grad():
            losses, metrics = _losses(state.model, spec, cfg, batch,
                                      compute_metrics=True, psum=psum)
        return _totals(losses, metrics, psum)

    return step

