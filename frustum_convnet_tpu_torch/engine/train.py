"""Training driver CLI of the port, on one device or one rank a device:
``python -m frustum_convnet_tpu_torch.engine.train --cfg <yaml> [--device cuda] [KEY VAL]...``

Counterpart of ``frustum_convnet_tpu/engine/train.py:86-392``: config merge,
seeded setup, the registered provider, the epoch loop with disp-interval
logging, per-epoch validation with best-model selection on the in-loop
``IoU_<thresh>`` metric, the reference checkpoint cadence, RESUME /
TRAIN.WEIGHTS with the fine-tune quirk, EVAL_MODE and the config snapshot.
As in the JAX driver:

* epoch loss averages cover every step and metric averages the sampled
  steps (``TPU.METRIC_INTERVAL``, -1 = every ``disp`` steps; the metric-free
  twin step runs in between). They accumulate on the device and are read
  once per epoch; the host syncs mid-epoch only at disp intervals, where a
  non-finite loss aborts the run;
* the train loader shuffles and drops the last partial batch; the val
  loader keeps it and runs it as it is;
* the model computes in ``TPU.COMPUTE_DTYPE`` (its trunk and heads in
  ``TPU.TRUNK_DTYPE``) with ``TPU.{BN_GROUP_SIZE, FAST_BN, FAST_BN_FIRST,
  REMAT_POINTNET}``; parameters, BatchNorm statistics and Adam state stay
  float32, and the validation epochs run the training dtype;
* ``TPU.F32_FINETUNE_EPOCHS`` N > 0 with a half-precision compute dtype
  computes fully in float32 (no trunk dtype) from epoch
  ``max(MAX_EPOCH - N, 0)`` on: the same model, parameters, Adam moments
  and schedule count.

Data parallelism, as the JAX driver trains under its mesh
(``engine/train.py:207-249`` of the JAX package): run one process a card,
each with ``--device cuda`` and ``FRUSTUM_COORDINATOR=host:port``,
``FRUSTUM_NUM_PROCESSES=N`` and ``FRUSTUM_PROCESS_ID=r`` (or a launcher's
``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` with
``FRUSTUM_DIST=auto``; ``parallel.mesh``). Rank r trains on
``cuda:(r % device_count)`` over NCCL (gloo on the CPU) and reads its shard
of every global batch, ``TRAIN.BATCH_SIZE / N`` frustums; the BatchNorm
statistics, losses and metrics are the global batch's, the gradients are
summed over the ranks, and the parameters stay bitwise equal on every rank.
Every rank evaluates the val loader's short global tail whole, and the
epoch weights it by its own count. Rank 0 alone writes ``train.log``, the
scalars, the config snapshot and the checkpoints. ``main`` leaves a process
group it joined itself before it returns.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.data.registry import get_provider_class
from frustum_convnet_tpu_torch.engine import checkpoints as ckpt
from frustum_convnet_tpu_torch.engine.loader import BatchLoader
from frustum_convnet_tpu_torch.engine.test import strict_fp32
from frustum_convnet_tpu_torch.models import det
from frustum_convnet_tpu_torch.models.net import FrustumConvNet
from frustum_convnet_tpu_torch.ops.select_cuda import group_depth_point_multi_cuda
from frustum_convnet_tpu_torch.parallel import mesh
from frustum_convnet_tpu_torch.parallel.train_step import (
    TrainState, TrainStepConfig, build_eval_step, build_train_step_accum,
    init_accum, make_optimizer, multistep_lr, reset_schedule_count, to_device)
from frustum_convnet_tpu_torch.utils.logger import ScalarWriter, get_logger
from frustum_convnet_tpu_torch.utils.metrics import TrainingStates


def save_cfg_snapshot(path: str, cfg, spec) -> None:
    """Dump the resolved cfg + model spec for reproducibility."""
    import yaml

    def plain(o):
        if isinstance(o, dict):
            return {k: plain(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [plain(v) for v in o]
        if isinstance(o, (np.integer, np.floating)):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
        return o

    payload = {"cfg": plain(dict(cfg)), "spec": plain(dataclasses.asdict(spec))}
    with open(path, "w") as f:
        yaml.safe_dump(payload, f, default_flow_style=None, sort_keys=True)


class _Step:
    """The train step(s) for run_epoch_train: ``fn`` carries the monitoring
    metrics; ``fast_fn`` (optional) is the metric-free twin used between
    metric samples, whose accumulator holds only ``loss_keys``."""

    def __init__(self, fn, device, fast_fn=None, loss_keys=()):
        self.fn = fn
        self.device = device
        self.fast_fn = fast_fn
        self.loss_keys = tuple(loss_keys)


class _Clock:
    """Elapsed time of a stretch of device work: CUDA events on the current
    stream for a CUDA device (read after the stream has caught up), the host
    clock for the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start_ev = torch.cuda.Event(enable_timing=True)
            self.end_ev = torch.cuda.Event(enable_timing=True)
            self.start_ev.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.end_ev.record()
        else:
            self.t1 = time.perf_counter()

    def seconds(self) -> float:
        if self.cuda:
            self.end_ev.synchronize()
            return self.start_ev.elapsed_time(self.end_ev) / 1e3
        return self.t1 - self.t0


def run_epoch_train(step: _Step, state: TrainState, accum, loader, epoch,
                    logger, writer, disp, metric_interval=1):
    """One training epoch with on-device per-iteration accumulation.

    Returns (averages, stats): loss averages over every step and metric
    averages over the sampled steps; stats = {"steps", "frustums",
    "seconds", "ms_per_step", "frustums_per_s"}, timed on the device from
    the first step's launch to the last step's end; the frustums are the
    global batches' (every rank's shard).
    """
    n_steps = n_metric = n_frustums = 0
    clock = None
    for i, batch_np in enumerate(loader.epoch(epoch)):
        batch = to_device(batch_np, step.device)
        if clock is None:
            clock = _Clock(step.device)
        on_metric = (step.fast_fn is None or metric_interval <= 1
                     or (i + 1) % metric_interval == 0 or i == 0)
        if on_metric:
            losses, metrics = step.fn(state, accum, batch)
            n_metric += 1
        else:
            # loss-only step: the metric slots of the accumulator stay as
            # they are
            sub = {k: accum[k] for k in step.loss_keys}
            losses, metrics = step.fast_fn(state, sub, batch)
        n_steps += 1
        n_frustums += len(batch_np["point_cloud"]) * loader.process_count
        if (i + 1) % disp == 0 or i == 0:
            vals = {k: float(v) for k, v in {**losses, **metrics}.items()}
            line = " ".join(f"{k} {v:.4f}" for k, v in vals.items())
            logger.info(f"epoch {epoch} it {i + 1}/{len(loader)} {line}")
            # fail loudly on a numeric blow-up (the half-precision overflow
            # class); piggybacks on the disp-interval sync, costing nothing
            # extra
            if not np.isfinite(vals.get("total_loss", 0.0)):
                raise RuntimeError(
                    f"non-finite total_loss at epoch {epoch} it {i + 1}: "
                    f"{vals} — with TPU.COMPUTE_DTYPE=float16 this is the "
                    f"weight-gradient overflow hazard (see configs/config.py "
                    f"COMPUTE_DTYPE); use float32/bfloat16 or the "
                    f"F32_FINETUNE_EPOCHS schedule")
    seconds = 0.0
    if clock is not None:
        clock.stop()
        seconds = clock.seconds()
    loss_keys = frozenset(step.loss_keys)
    avg = {k: float(v) / max(n_steps if k in loss_keys else n_metric, 1)
           for k, v in accum.items()}
    if writer:
        writer.scalars({f"train/{k}": v for k, v in avg.items()}, epoch)
    stats = {"steps": n_steps, "frustums": n_frustums, "seconds": seconds,
             "ms_per_step": 1e3 * seconds / max(n_steps, 1),
             "frustums_per_s": n_frustums / seconds if seconds > 0 else 0.0}
    return avg, stats


def run_epoch_eval(eval_fn, eval_fn_tail, state: TrainState, loader, epoch,
                   logger, writer, device) -> dict:
    """Validation epoch: batch-size-weighted averages over the FULL val set
    (``drop_last=False``). A full batch's values are the global batch's
    (every rank's shard), weighted by the global batch size; the short
    global tail runs whole on every rank through ``eval_fn_tail``, with no
    collective, weighted by its own count, as in the JAX driver. Returns
    the averages."""
    states = TrainingStates()
    for batch_np in loader.epoch(epoch):
        if batch_np.pop("_global_tail", False):
            losses, metrics = eval_fn_tail(state, to_device(batch_np, device))
            weight = len(batch_np["point_cloud"])
        else:
            losses, metrics = eval_fn(state, to_device(batch_np, device))
            weight = loader.global_batch
        vals = {k: float(v) for k, v in {**losses, **metrics}.items()}
        states.update_states(vals, n=weight)
    result = states.get_states()
    logger.info(f"[val] epoch {epoch} " + states.format_states())
    if writer:
        writer.scalars({f"val/{k}": v for k, v in result.items()}, epoch)
    return result


def make_datasets(cfg):
    """The config's (train, val) splits through its registered provider:
    train with the random flip and depth shift, val as it is."""
    provider_cls = get_provider_class(cfg)
    train_ds = provider_cls(cfg, cfg.TRAIN.DATASET, random_flip=True,
                            random_shift=True, one_hot=True,
                            extend_from_det=cfg.DATA.EXTEND_FROM_DET)
    val_ds = provider_cls(cfg, cfg.TEST.DATASET, one_hot=True,
                          extend_from_det=cfg.DATA.EXTEND_FROM_DET)
    return train_ds, val_ds


def main(argv=None, matmul_precision: str = "highest"):
    """Run the driver. ``matmul_precision`` is a diagnostic of the Python
    API (no flag, no config key): the float32 matmul precision of the run
    (``torch.set_float32_matmul_precision``; the convolutions stay strict),
    "highest" unless a caller asks for less, and "highest" again when the
    call returns. Returns {"state": the final TrainState, "start_epoch",
    "best_prec", "best_epoch", "epochs": [{"epoch", "prec", "dtype" (the
    epoch's compute dtype), "train" and "val" (the epoch's averages),
    **train stats}], "output_dir", "rank", "world", "backend" (the process
    group's, None without one)}."""
    parser = argparse.ArgumentParser(description="Train FrustumConvNet (PyTorch)")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cuda:N or cpu)")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)

    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(args.cfg_file, cfg)
    if args.opts:
        configs.merge_cfg_from_list(args.opts, cfg)
    configs.assert_and_infer_cfg(cfg)
    compute_dtype = configs.get_compute_dtype(cfg, train=True)
    trunk_dtype = configs.get_trunk_dtype(cfg)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible")
    # the process group before anything touches the device (env-gated)
    with mesh.distributed(device) as device:
        try:
            return _train(cfg, args, device, compute_dtype, trunk_dtype,
                          matmul_precision)
        finally:  # the precision is the run's alone
            if matmul_precision != "highest":
                torch.set_float32_matmul_precision("highest")


def _train(cfg, args, device, compute_dtype, trunk_dtype, matmul_precision) -> dict:
    strict_fp32()
    if matmul_precision != "highest":
        torch.set_float32_matmul_precision(matmul_precision)
    world, rank = mesh.make_mesh(cfg.TPU.MESH_SHAPE, cfg.TPU.MESH_AXES), mesh.process_index()
    chief = mesh.is_chief()

    output_dir = cfg.OUTPUT_DIR
    if chief:  # files belong to rank 0; the other ranks log to the console
        os.makedirs(output_dir, exist_ok=True)
    logger = get_logger(os.path.join(output_dir, "train.log") if chief else None)
    logger.info(f"config: {args.cfg_file} overrides: {args.opts} on {device}"
                + (f", rank {rank} of {world}" if mesh.initialized() else ""))
    if matmul_precision != "highest":
        logger.info(f"float32 matmul precision {torch.get_float32_matmul_precision()} "
                    f"(cuBLAS TF32 {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
                    f"TF32 {torch.backends.cudnn.allow_tf32})")

    seed = cfg.TRAIN.SEED
    np.random.seed(seed)
    torch.manual_seed(seed)

    spec = configs.get_model_spec(cfg)
    model = FrustumConvNet(spec, dtype=compute_dtype, trunk_dtype=trunk_dtype,
                           fast_bn=cfg.TPU.FAST_BN,
                           fast_bn_first=cfg.TPU.FAST_BN_FIRST,
                           remat_pointnet=cfg.TPU.REMAT_POINTNET,
                           bn_group=cfg.TPU.BN_GROUP_SIZE)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device)

    train_ds, val_ds = make_datasets(cfg)
    # each rank reads its shard of every global batch; the val loader's
    # short global tail comes whole to every rank
    train_loader = BatchLoader(train_ds, cfg.TRAIN.BATCH_SIZE, spec.num_scales,
                               shuffle=True, drop_last=True, seed=seed,
                               prefetch=cfg.TPU.PREFETCH,
                               process_index=rank, process_count=world,
                               num_workers=cfg.NUM_WORKERS)
    val_loader = BatchLoader(val_ds, cfg.TEST.BATCH_SIZE, spec.num_scales,
                             shuffle=False, drop_last=False,
                             process_index=rank, process_count=world)
    group = cfg.TPU.BN_GROUP_SIZE
    if group > 0 and train_loader.local_batch % group:
        raise ValueError(
            f"TPU.BN_GROUP_SIZE {group} must divide each rank's batch: "
            f"TRAIN.BATCH_SIZE {cfg.TRAIN.BATCH_SIZE} over {world} rank(s) is "
            f"{train_loader.local_batch} a rank")
    logger.info(f"train {len(train_ds)} frustums / {len(train_loader)} batches; "
                f"val {len(val_ds)} frustums")

    step_cfg = TrainStepConfig(
        base_lr=cfg.TRAIN.BASE_LR, min_lr=cfg.TRAIN.MIN_LR,
        gamma=cfg.TRAIN.GAMMA, lr_steps=list(cfg.TRAIN.LR_STEPS),
        warmup_epochs=cfg.TRAIN.WARMUP_EPOCHS,
        steps_per_epoch=max(len(train_loader), 1),
        weight_decay=cfg.TRAIN.WEIGHT_DECAY, optimizer=cfg.TRAIN.OPTIMIZER,
        momentum=cfg.TRAIN.MOMENTUM,
        loss_weights={"box": cfg.LOSS.BOX_LOSS_WEIGHT,
                      "corner": cfg.LOSS.CORNER_LOSS_WEIGHT,
                      "head_res": cfg.LOSS.HEAD_REG_WEIGHT,
                      "size_res": cfg.LOSS.SIZE_REG_WEIGHT},
        iou_thresh=cfg.IOU_THRESH,
    )
    state = TrainState(model, make_optimizer(model.parameters(), step_cfg),
                       multistep_lr(step_cfg))

    start_epoch, best_prec, best_epoch = cfg.TRAIN.START_EPOCH, 0.0, 0
    paths = ckpt.checkpoint_paths(output_dir)
    if cfg.RESUME or cfg.TRAIN.WEIGHTS:
        path = cfg.TRAIN.WEIGHTS or paths["final"]
        payload = ckpt.load_train_checkpoint(path, state)
        start_epoch, best_prec = payload["epoch"], payload["best_prec"]
        best_epoch = payload["best_epoch"]
        if start_epoch == cfg.TRAIN.MAX_EPOCH:  # fine-tune-from quirk
            # the reference restarts its epoch-indexed LR scheduler at base
            # LR for the fine-tune run while keeping the optimizer moments
            start_epoch, best_prec, best_epoch = 0, 0.0, 0
            reset_schedule_count(state.optimizer)
            state.step = 0
        logger.info(f"resumed from {path} at epoch {start_epoch}")

    train_fn = build_train_step_accum(spec, step_cfg)
    # metric cadence: -1 -> sample the monitoring metrics at cfg.disp
    # intervals; 1 -> every step (reference parity); N -> every N steps
    metric_interval = cfg.TPU.METRIC_INTERVAL
    if metric_interval < 0:
        metric_interval = cfg.disp
    fast_fn = None
    if metric_interval > 1:
        fast_fn = build_train_step_accum(
            spec, dataclasses.replace(step_cfg, compute_metrics=False))
    eval_fn = build_eval_step(spec, step_cfg)
    eval_fn_tail = build_eval_step(spec, step_cfg, local=True)
    iou_key = f"IoU_{cfg.IOU_THRESH}"
    accum_keys = det.LOSS_KEYS + det.metric_keys(cfg.IOU_THRESH)
    writer = ScalarWriter(output_dir, "train") if cfg.USE_TFBOARD and chief else None
    if chief:
        save_cfg_snapshot(os.path.join(output_dir, "config_snapshot.yaml"), cfg, spec)

    result = {"state": state, "start_epoch": start_epoch, "epochs": [],
              "output_dir": output_dir, "rank": rank, "world": world,
              "backend": mesh.backend()}
    if cfg.EVAL_MODE:
        val = run_epoch_eval(eval_fn, eval_fn_tail, state, val_loader, 0, logger,
                             writer, device)
        result.update(prec=val.get(iou_key, 0.0), best_prec=best_prec,
                      best_epoch=best_epoch)
        return result

    # the final F32_FINETUNE_EPOCHS epochs of a half-precision run compute
    # fully in float32; the state and the schedule carry straight on
    ft_start = None
    if cfg.TPU.F32_FINETUNE_EPOCHS > 0 and compute_dtype != torch.float32:
        ft_start = max(cfg.TRAIN.MAX_EPOCH - cfg.TPU.F32_FINETUNE_EPOCHS, 0)

    step = _Step(train_fn, device, fast_fn=fast_fn, loss_keys=det.LOSS_KEYS)
    launches = group_depth_point_multi_cuda.launches
    for epoch in range(start_epoch, cfg.TRAIN.MAX_EPOCH):
        t0 = time.time()
        finetune = ft_start is not None and epoch >= ft_start
        if finetune and epoch == ft_start:
            logger.info(f"epoch {epoch}: switching to float32 fine-tune "
                        f"steps (TPU.F32_FINETUNE_EPOCHS="
                        f"{cfg.TPU.F32_FINETUNE_EPOCHS})")
        if finetune:
            model.set_precision(torch.float32)
        else:
            model.set_precision(compute_dtype, trunk_dtype)
        train_avg, stats = run_epoch_train(step, state, init_accum(accum_keys, device),
                                           train_loader, epoch, logger, writer,
                                           cfg.disp, metric_interval=metric_interval)
        val = run_epoch_eval(eval_fn, eval_fn_tail, state, val_loader, epoch,
                             logger, writer, device)
        prec = val.get(iou_key, 0.0)
        is_best = prec > best_prec
        if is_best:
            best_prec, best_epoch = prec, epoch + 1
        logger.info(f"epoch {epoch} done in {time.time() - t0:.1f}s "
                    f"({stats['ms_per_step']:.2f} ms/step, "
                    f"{stats['frustums_per_s']:.1f} frustums/s training) "
                    f"{iou_key}={prec:.4f} best={best_prec:.4f}@{best_epoch}")
        if chief:
            ckpt.maybe_save_epoch(output_dir, state, epoch, cfg.TRAIN.MAX_EPOCH,
                                  best_prec, best_epoch, is_best)
        result["epochs"].append({"epoch": epoch, "prec": prec,
                                 "dtype": str(model.dtype).split(".")[-1],
                                 "train": train_avg, "val": val, **stats})
    logger.info(f"training done; best {iou_key}={best_prec:.4f} at epoch {best_epoch}")
    logger.info(f"{group_depth_point_multi_cuda.launches - launches} grouping kernel "
                f"launches in training")
    result.update(best_prec=best_prec, best_epoch=best_epoch)
    return result


if __name__ == "__main__":
    main()
