"""Checkpoints of the port: reference-layout ``.pth`` files.

The port's model is named in the reference state-dict layout, so a
``.pth`` written by the reference (``train/train_net_det.py:384-390``), by
``tools/export_reference_checkpoint.py`` from a JAX ``.msgpack`` (run on a
host with jax), by :func:`save_checkpoint` or by the trainer's
:func:`save_train_checkpoint` loads as it is, and
``tools/import_reference_checkpoint.py`` reads what the trainer writes.

The trainer's payload is ``{"state_dict", "optimizer", "epoch",
"best_prec", "best_epoch", "step"}``, with the reference cadence of
``frustum_convnet_tpu/engine/checkpoints.py:56-78``: ``model_%04d.pth``
every 5 epochs, ``model_best.pth`` on a new best in-loop IoU metric and
``model_final.pth`` at the last epoch.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from frustum_convnet_tpu_torch.models.weights import load_pth


def load_checkpoint(path: str, model: nn.Module) -> None:
    """Load ``path`` into ``model`` with ``strict=True``: every key must match."""
    model.load_state_dict(load_pth(path), strict=True)


def _write(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _cpu_state(model: nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_checkpoint(path: str, model: nn.Module, epoch: int = 0) -> None:
    """Write ``{"state_dict": ..., "epoch": ...}``, the reference's wrapped form."""
    _write(path, {"state_dict": _cpu_state(model), "epoch": int(epoch)})


def save_train_checkpoint(path: str, state, epoch: int, best_prec: float = 0.0,
                          best_epoch: int = 0) -> None:
    """The train state (a ``parallel.train_step.TrainState``) with the
    epoch and best-model bookkeeping."""
    _write(path, {
        "state_dict": _cpu_state(state.model),
        "optimizer": state.optimizer.state_dict(),
        "epoch": int(epoch),
        "best_prec": float(best_prec),
        "best_epoch": int(best_epoch),
        "step": int(state.step),
    })


def load_train_checkpoint(path: str, state) -> dict:
    """Restore the model (strictly) and the optimizer of ``state`` from a
    trainer's ``.pth``, and its step count; returns the payload's epoch,
    best_prec and best_epoch. The optimizer's state moves to its
    parameters' device."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["state_dict"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return {k: payload[k] for k in ("epoch", "best_prec", "best_epoch")}


def checkpoint_paths(output_dir: str):
    d = os.path.join(output_dir, "checkpoints")
    return {
        "periodic": lambda epoch: os.path.join(d, f"model_{epoch:04d}.pth"),
        "best": os.path.join(d, "model_best.pth"),
        "final": os.path.join(d, "model_final.pth"),
    }


def maybe_save_epoch(output_dir: str, state, epoch: int, max_epoch: int,
                     best_prec: float, best_epoch: int, is_best: bool,
                     period: int = 5) -> Optional[str]:
    """Apply the reference cadence; returns the periodic path if written."""
    paths = checkpoint_paths(output_dir)
    written = None
    if (epoch + 1) % period == 0:
        written = paths["periodic"](epoch + 1)
        save_train_checkpoint(written, state, epoch + 1, best_prec, best_epoch)
    if is_best:
        save_train_checkpoint(paths["best"], state, epoch + 1, best_prec, best_epoch)
    if epoch + 1 == max_epoch:
        save_train_checkpoint(paths["final"], state, epoch + 1, best_prec, best_epoch)
    return written
