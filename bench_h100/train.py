"""The training job: ``engine.train.run_epoch_train`` over batches made in set-up.

Set-up makes the traffic's labeled frustums from the seed
(``frozen.synthetic``), the provider's training items of them with its flip
and shift (``frozen.items``), collates them into ``steps_per_epoch`` batches,
makes the weights on the device (``reference.model.seeded_params``) and
builds one training state as the program's trainer does (model, Adam, the
schedule, the metric step and its metric-free twin at the config's cadence).
One call of ``run_epoch_train`` on the first three batches warms every
shape; ``warm_calls`` epochs more may follow.

The window hands that same state to ``run_epoch_train`` again and again,
each call an epoch that replays the batches in order, until the calls have
taken ``seconds``; the rate is every frustum of every step over the time
from the first call's start to the last call's end. Before every call the
state is set back in place to the seeded weights, Adam's moments and step
counts at nought and the schedule at its start (``reset``), so each call's
first ``CHECKED_STEPS`` steps are the reference's: their losses, the first
gradient as Adam took it and the parameters' change after them are read
on the device as the steps run (``Recorder``) and compared for every call.
With ``trace`` the steps ``trace_steps`` of the window's second call run
under the profiler; the profiler's start, export and reduction are left out
of the rate.

After the window the program's state is freed and the reference follows
the three steps from the same weights and batches (``reference.train``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bench_h100 import common
from bench_h100.frozen import items as frozen_items
from bench_h100.frozen.kernel1_cost import launch_bound
from bench_h100.reference import model as ref_model
from bench_h100.reference import train as ref_train
from bench_h100.reference.spec import ModelSpec
from bench_h100.trace import Traced

CHECKED_STEPS = 3

# the job's traffic at the CPU tests' size (bench_h100/tests/tiny.py) and at
# the card control test's (test_h100bench_control.py: four batches of the
# b128 traffic's 128); ``cfg`` merges key by key
TINY = {"batch": 4, "steps_per_epoch": 6, "frustums": 24, "trace_steps": [2, 4],
        "warm_calls": 0, "cfg": {"TRAIN.BATCH_SIZE": 4, "disp": 3}}
SMALL = {"steps_per_epoch": 4, "frustums": 4 * 128}


class ReplayLoader:
    """``run_epoch_train``'s loader: the prepared batches, in order, every
    epoch. ``before(i)`` runs before batch i is handed over, and
    ``before(len(batches))`` once the last is."""

    process_count = 1

    def __init__(self, batches: list, before=None):
        self.batches = batches
        self.global_batch = len(batches[0]["point_cloud"])
        self.before = before

    def __len__(self):
        return len(self.batches)

    def epoch(self, epoch: int):
        for i, batch in enumerate(self.batches):
            if self.before is not None:
                self.before(i)
            yield batch
        if self.before is not None:
            self.before(len(self.batches))


class Recorder:
    """Wraps the step functions to read, on the device and without a
    synchronize, the first ``CHECKED_STEPS`` steps of each call that
    ``start`` opens: each step's total loss, the norm by leaf of the
    gradient Adam took at the first step (its first moment over
    1 - beta1) and of the parameters' change from ``init`` after the last
    checked step."""

    def __init__(self, init: dict):
        self.init = init
        self.calls, self.count = [], CHECKED_STEPS

    def start(self) -> None:
        self.calls.append({"losses": []})
        self.count = 0

    def _norms(self, leaves):
        return torch.stack([torch.linalg.vector_norm(t.detach().double()) for t in leaves])

    def wrap(self, fn):
        if fn is None:
            return None

        def step(state, accum, batch):
            out = fn(state, accum, batch)
            if self.count < CHECKED_STEPS:
                self.count += 1
                call = self.calls[-1]
                call["losses"].append(out[0]["total_loss"].detach().clone())
                named = list(state.model.named_parameters())
                if self.count == 1:
                    opt = state.optimizer
                    call["first_grad"] = self._norms(
                        opt.state[p]["exp_avg"] if "exp_avg" in opt.state.get(p, {})
                        else torch.zeros_like(p) for _, p in named) / (1 - ref_train.BETAS[0])
                if self.count == CHECKED_STEPS:
                    call["change"] = self._norms(p - self.init[k] for k, p in named)
            return out

        return step

    def readings(self, names: list) -> list:
        """Each call's readings, on the host: {"losses": [...],
        "first_grad": {leaf: norm}, "change": {leaf: norm}}."""
        return [{"losses": [float(x) for x in c["losses"]],
                 **{k: dict(zip(names, c[k].tolist())) for k in ("first_grad", "change")}}
                for c in self.calls]


def reset(s: dict) -> None:
    """Sets the training state back to where set-up began, in place (the
    tensors the program holds stay the same): the seeded weights and
    BatchNorm statistics, every tensor of the optimizer's state at nought
    (Adam's moments and step counts, which is a fresh Adam), the schedule at
    its first step; then opens a call of the recorder."""
    state = s["state"]
    with torch.no_grad():
        for k, v in state.model.state_dict().items():
            v.copy_(s["init"][k])
        for per in state.optimizer.state.values():
            for v in per.values():
                v.zero_()
    for group in state.optimizer.param_groups:
        group["schedule_count"] = 0
    state.step = 0
    s["recorder"].start()


def prepare(job: dict) -> dict:
    """Set-up short of the checked steps: the batches, the weights and the
    training state with its step functions, as the program's trainer
    builds them; ``epoch(loader, index)`` is one call of ``run_epoch_train``."""
    from frustum_convnet_tpu_torch import configs
    from frustum_convnet_tpu_torch.engine.test import strict_fp32
    from frustum_convnet_tpu_torch.engine.train import _Step, run_epoch_train
    from frustum_convnet_tpu_torch.models import det
    from frustum_convnet_tpu_torch.parallel.train_step import (
        TrainState, TrainStepConfig, build_train_step_accum, init_accum, make_optimizer,
        multistep_lr)

    config, traffic, device, log = job["config"], job["traffic"], job["device"], job["log"]
    spec = ModelSpec.from_config(config["model"])
    cfg = common.program_cfg(config, traffic.get("cfg", {}))
    spec_p = configs.get_model_spec(cfg)
    common.check_spec(spec_p, spec)
    strict_fp32()  # as the program's trainer sets it before it builds anything
    rng = np.random.default_rng(job["seed"])
    rec = common.frustum_records(config, traffic, rng, labeled=True)
    items = common.make_items(rec, spec, rng, labeled=True)
    log(f"[setup] {len(items)} items made at {time.time() - job['t_start']:.2f} s")
    per = traffic["batch"]
    batches = [frozen_items.collate_batch(items[i:i + per], spec.num_scales)
               for i in range(0, len(items) - per + 1, per)]
    params = ref_model.seeded_params(spec, job["seed"], device)
    model = common.program_model(spec_p, params, device,
                                 dtype=configs.get_compute_dtype(cfg, train=True))
    step_cfg = TrainStepConfig(
        base_lr=cfg.TRAIN.BASE_LR, min_lr=cfg.TRAIN.MIN_LR, gamma=cfg.TRAIN.GAMMA,
        lr_steps=list(cfg.TRAIN.LR_STEPS), warmup_epochs=cfg.TRAIN.WARMUP_EPOCHS,
        steps_per_epoch=len(batches), weight_decay=cfg.TRAIN.WEIGHT_DECAY,
        optimizer=cfg.TRAIN.OPTIMIZER, momentum=cfg.TRAIN.MOMENTUM,
        loss_weights={"box": cfg.LOSS.BOX_LOSS_WEIGHT, "corner": cfg.LOSS.CORNER_LOSS_WEIGHT,
                      "head_res": cfg.LOSS.HEAD_REG_WEIGHT,
                      "size_res": cfg.LOSS.SIZE_REG_WEIGHT},
        iou_thresh=cfg.IOU_THRESH)
    state = TrainState(model, make_optimizer(model.parameters(), step_cfg),
                       multistep_lr(step_cfg))
    metric_interval = cfg.TPU.METRIC_INTERVAL if cfg.TPU.METRIC_INTERVAL > 0 else cfg.disp
    fast_fn = (build_train_step_accum(spec_p, dataclasses.replace(step_cfg, compute_metrics=False))
               if metric_interval > 1 else None)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    recorder = Recorder(init)
    step = _Step(recorder.wrap(build_train_step_accum(spec_p, step_cfg)), device,
                 fast_fn=recorder.wrap(fast_fn), loss_keys=det.LOSS_KEYS)
    accum_keys = det.LOSS_KEYS + det.metric_keys(cfg.IOU_THRESH)
    logger = common.quiet_logger()

    def epoch(loader, index):
        return run_epoch_train(step, state, init_accum(accum_keys, device), loader, index,
                               logger, None, cfg.disp, metric_interval=metric_interval)

    log(f"[setup] inputs and weights ready at {time.time() - job['t_start']:.2f} s")
    return {"cfg": cfg, "spec": spec, "batches": batches, "params": params, "model": model,
            "state": state, "init": init, "recorder": recorder, "epoch": epoch,
            "names": [k for k, _ in model.named_parameters()]}


def call(s: dict, loader, index: int) -> dict:
    """One call of ``run_epoch_train`` from the reset state; its stats."""
    reset(s)
    return s["epoch"](loader, index)[1]


def release(s: dict, device) -> None:
    """Frees the program's training state before the reference runs."""
    for k in ("model", "state", "init", "recorder", "epoch"):
        s.pop(k, None)
    if device.type == "cuda":
        torch.cuda.empty_cache()


def check(s: dict, readings: list, device) -> tuple:
    """The numbers of the program's readings (``Recorder.readings``, one a
    call) against the reference's steps, each the largest over the calls,
    and those steps."""
    cfg = s["cfg"]
    ref = ref_train.steps(s["params"], s["names"], s["spec"], s["batches"][:CHECKED_STEPS],
                          cfg.TRAIN.BASE_LR, cfg.TRAIN.WEIGHT_DECAY, device)
    gaps = [ref_train.compare(r, ref) for r in readings]
    return {k: max(g[k] for g in gaps) for k in gaps[0]}, ref


def run(job: dict) -> dict:
    device, log, traffic = job["device"], job["log"], job["traffic"]
    s = prepare(job)
    batches = s["batches"]
    call(s, ReplayLoader(batches[:CHECKED_STEPS]), 0)  # warms every shape
    for i in range(traffic["warm_calls"]):
        call(s, ReplayLoader(batches), -1 - i)
    traced = {"tr": None, "steps": []}
    lo, hi = traffic["trace_steps"]

    def before(i):
        if i == lo:
            traced["tr"] = Traced(device).__enter__()
        if lo <= i < hi:
            traced["steps"].append(i)
        if i == hi and traced["tr"] is not None:
            traced["tr"].__exit__(None, None, None)

    def elapsed():
        # the profiler's start, export and reduction are not the program's time
        return time.time() - t_first - (traced["tr"].overhead_s if traced["tr"] else 0.0)

    setup_s = time.time() - job["t_start"]
    log(f"[setup] warm steps done at {setup_s:.2f} s")
    calls = []
    t_first = time.time()
    while not calls or elapsed() < job["seconds"] or (job["trace"] and len(calls) < 2):
        tracing = job["trace"] and len(calls) == 1
        stats = call(s, ReplayLoader(batches, before if tracing else None), len(calls) + 1)
        calls.append({"end": elapsed(), "frustums": stats["frustums"], "steps": stats["steps"]})
    window_s = calls[-1]["end"]
    frustums = sum(c["frustums"] for c in calls)
    log("[window] seconds a call " + " ".join(
        f"{b['end'] - a:.4f}" for a, b in zip([0.0] + [c["end"] for c in calls], calls)))
    device_numbers = common.device_info(device, job["chips"])
    readings = s["recorder"].readings(s["names"])
    release(s, device)

    t_check = time.time()
    numbers, ref = check(s, readings, device)
    log(f"[check] {len(calls)} calls of {len(batches)} steps in {window_s:.2f} s; losses "
        f"{[r['losses'] for r in readings]} against {ref['losses']}; the check took "
        f"{time.time() - t_check:.2f} s")
    summary = traced["tr"].summary if traced["tr"] is not None else None
    ctx = {"job": "train", "spec": s["spec"], "rate": frustums / window_s,
           "frustums": frustums, "trace": summary, "kernel1_bound_s": None}
    if summary is not None:
        spec = s["spec"]
        ctx["kernel1_launches"] = len(traced["steps"])
        ctx["kernel1_bound_s"] = sum(
            launch_bound(*_grouping_inputs(batches[i], device), spec.height_half,
                         spec.nsamples)["seconds"] for i in traced["steps"])
    return {"end_to_end": {"train_frustums_per_s": frustums / window_s, "setup_s": setup_s},
            "numbers": numbers, "attempted": sum(c["steps"] for c in calls), "failed": 0,
            "device": device_numbers, "ctx": ctx, "window_s": window_s}


def _half(batch: dict) -> dict:
    b = len(batch["point_cloud"]) // 2
    return {k: tuple(r[:b] for r in v) if k == "refs" else v[:b] for k, v in batch.items()}


def readings(job: dict, control: bool) -> dict:
    """The check's numbers of one call of ``run_epoch_train`` over the
    checked steps (``program``) and, with ``control``, those of the
    reference's steps computed in TF32 (``control``) and of its steps on
    the first half of each batch, the mean taken over it (``half_batch``)."""
    device = job["device"]
    s = prepare(job)
    call(s, ReplayLoader(s["batches"][:CHECKED_STEPS]), 0)
    program = s["recorder"].readings(s["names"])
    release(s, device)
    out = {}
    out["program"], ref = check(s, program, device)
    if control:
        cfg, first = s["cfg"], s["batches"][:CHECKED_STEPS]
        lr, wd = cfg.TRAIN.BASE_LR, cfg.TRAIN.WEIGHT_DECAY
        ctl = ref_train.steps(s["params"], s["names"], s["spec"], first, lr, wd, device,
                              allow_tf32=True)
        out["control"] = ref_train.compare(ref_train.readings(ctl), ref)
        half = ref_train.steps(s["params"], s["names"], s["spec"],
                               [_half(b) for b in first], lr, wd, device)
        out["half_batch"] = ref_train.compare(ref_train.readings(half), ref)
    return out


def _grouping_inputs(batch: dict, device):
    pts = torch.from_numpy(np.ascontiguousarray(batch["point_cloud"])).to(device)
    return pts, [torch.from_numpy(np.ascontiguousarray(r)).to(device) for r in batch["refs"]]
