"""Train-step timing of the flagship KITTI model on one CUDA card:
``python -m frustum_convnet_tpu_torch.tools.profile_train [--batch 32] [--dtype bfloat16] ...``

Counterpart of ``tools/profile_train.py``, with its flags and rows:

* eval forward + losses/metrics (running BatchNorm statistics);
* the train-mode forward, loss and metrics without gradients (BatchNorm
  batch statistics);
* the full step with the per-step IoU metric off;
* the full step (loss, gradients, Adam, BatchNorm update, metrics);
* the throughput line.

Each row is the best of 3 trials of 20 back-to-back calls, timed with CUDA
events on the card, TF32 off (``engine/test.strict_fp32``); the JAX tool's
scan-chained rows have no counterpart (they work around its relay's
dispatch). On the card each full step also gets its device-busy time and
kernel count a step (``torch.profiler`` over 8 steps) and the peak memory
of one step after the optimizer's state exists. The weights are the port's
seeded init (seed 3, the JAX tool's ``init_state(seed=3)``); the batch is
``data/fixtures.make_batch`` with labels. ``--device cpu --tiny`` runs the
rows at the tests' tiny shapes on the host clock; those times are the
CPU's.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.data.fixtures import make_batch
from frustum_convnet_tpu_torch.engine.test import strict_fp32
from frustum_convnet_tpu_torch.graft_entry import INIT_SEED, _flagship
from frustum_convnet_tpu_torch.models.det import compute_losses
from frustum_convnet_tpu_torch.models.net import FrustumConvNet
from frustum_convnet_tpu_torch.parallel import train_step as ts
from frustum_convnet_tpu_torch.utils.timing import time_calls

ITERS = 20
TRIALS = 3
PROFILED_STEPS = 8
FULL_STEP_ROWS = ("full train step (metrics OFF)", "full train step (grads+adam+BN+metrics)")


def device_profile(fn, device: torch.device, steps: int = PROFILED_STEPS) -> dict:
    """A step's device-busy ms and kernels (``torch.profiler``, the mean over
    ``steps`` calls; busy is None when the profiler saw no device time) and
    the peak MiB that one call allocates on top of what it found."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize(device)
    events = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total", 0) or 0 for e in events)
    return {"device_ms": busy / steps / 1e3 if busy else None,
            "kernels": sum(e.count for e in events) / steps,
            "peak_mib": peak / 2 ** 20}


def main(argv=None) -> dict:
    """Time the rows; returns {"rows": {row: seconds a call},
    "frustums_per_s", "profile": {full-step row: device_profile} (the card
    only), "forwards": the model forwards run, "device": its name}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dtype", default="float32",
                    help="train compute dtype (cfg.TPU.COMPUTE_DTYPE)")
    ap.add_argument("--trunk_dtype", default="",
                    help="separate conv-trunk/heads dtype (cfg.TPU.TRUNK_DTYPE; "
                         "'' = follow --dtype)")
    ap.add_argument("--metrics", default="1", choices=("0", "1"),
                    help="compute the per-step IoU metric in the full step")
    ap.add_argument("--fast_bn", action="store_true",
                    help="analytic BN batch statistics (cfg.TPU.FAST_BN)")
    ap.add_argument("--fast_bn_first", action="store_true",
                    help="analytic BN stats on each scale's first MLP layer only "
                         "(cfg.TPU.FAST_BN_FIRST)")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize the PointNet MLP stacks in backward "
                         "(cfg.TPU.REMAT_POINTNET)")
    ap.add_argument("--bn_group", type=int, default=0,
                    help="ghost-BN group size (cfg.TPU.BN_GROUP_SIZE; 0 = global sync-BN)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the tests' tiny shapes and 2 calls a row (for the CPU)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card is visible; pass --device cpu to run on the CPU")
        strict_fp32()
    iters, trials = (2, 1) if args.tiny else (ITERS, TRIALS)

    cfg, _spec, _model = _flagship(tiny=args.tiny)
    configs.merge_cfg_from_list(["TRAIN.BATCH_SIZE", str(args.batch),
                                 "TPU.COMPUTE_DTYPE", args.dtype,
                                 "TPU.TRUNK_DTYPE", args.trunk_dtype], cfg)
    spec = configs.get_model_spec(cfg)
    model = FrustumConvNet(spec, dtype=configs.get_compute_dtype(cfg, train=True),
                           trunk_dtype=configs.get_trunk_dtype(cfg), fast_bn=args.fast_bn,
                           fast_bn_first=args.fast_bn_first, remat_pointnet=args.remat,
                           bn_group=args.bn_group)
    model.reset_parameters(torch.Generator().manual_seed(INIT_SEED))
    model.to(device)
    tcfg = ts.TrainStepConfig(compute_metrics=args.metrics == "1")
    state = ts.TrainState(model, ts.make_optimizer(model.parameters(), tcfg),
                          ts.multistep_lr(tcfg))
    batch = ts.to_device(make_batch(spec, batch=args.batch, seed=0, with_labels=True),
                         device)
    labels = {k: batch[k] for k in ts.LABEL_KEYS}
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}, batch {args.batch}, {args.dtype}"
          f"{' (tiny shapes)' if args.tiny else ''}", flush=True)
    forwards = 0

    def counted(fn):
        def call():
            nonlocal forwards
            forwards += 1
            return fn()
        return call

    eval_step = ts.build_eval_step(spec, tcfg)

    def fwd_train():
        model.train()
        with torch.no_grad():
            refs = list(batch["refs"])
            cls_logits, reg = model(batch["point_cloud"], batch["one_hot"], refs)
            losses, _ = compute_losses(spec, cls_logits, reg, refs[1], labels,
                                       tcfg.loss_weights, tcfg.iou_thresh)
        return losses["total_loss"]

    step_nm = ts.build_train_step(spec, dataclasses.replace(tcfg, compute_metrics=False))
    step = ts.build_train_step(spec, tcfg)
    stages = {"eval forward + losses/metrics": lambda: eval_step(state, batch),
              "train-mode fwd + loss + metrics (no grad)": fwd_train,
              FULL_STEP_ROWS[0]: lambda: step_nm(state, batch),
              FULL_STEP_ROWS[1]: lambda: step(state, batch)}
    rows, profiles = {}, {}
    for row, fn in stages.items():
        rows[row] = time_calls(counted(fn), device, iters, trials)
        print(f"{row:46s} {rows[row] * 1e3:8.3f} ms/step", flush=True)
        if device.type == "cuda" and row in FULL_STEP_ROWS:
            profiles[row] = prof = device_profile(counted(fn), device)
            busy = prof["device_ms"]
            print(f"{'  device busy, kernels, peak memory':46s} "
                  f"{'not measured' if busy is None else f'{busy:8.3f} ms'}, "
                  f"{prof['kernels']:.0f} kernels a step, {prof['peak_mib']:.1f} MiB",
                  flush=True)
    best = rows[FULL_STEP_ROWS[1]]
    print(f"train throughput: {args.batch / best:.0f} frustums/s on {name} (batch {args.batch})")
    if not all(np.isfinite(v) for v in rows.values()):
        raise AssertionError(f"non-finite row: {rows}")
    return {"rows": rows, "frustums_per_s": args.batch / best, "profile": profiles,
            "forwards": forwards, "device": name}


if __name__ == "__main__":
    main()
