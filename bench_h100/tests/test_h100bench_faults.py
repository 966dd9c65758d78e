"""A run whose timed path is broken underneath reads ``correct`` false: the
harness's look for a chip is skipped (CPU, tiny size) and the rest of the
run goes as it does on the card, with one fault planted in the program."""

import argparse

import numpy as np
import pytest
import torch

from bench_h100 import run
from bench_h100.tests import tiny
from frustum_convnet_tpu_torch.engine import test as driver
from frustum_convnet_tpu_torch.engine import train as trainer
from frustum_convnet_tpu_torch.parallel import train_step

SERVE, TRAIN = "kitti_car.serve_g8b32", "kitti_car.train_f32_b128"


def altered_answer(monkeypatch):
    """Each served box lies 0.1 m deeper than the model put it."""
    original = driver.from_prediction_to_label_format_batch

    def moved(*args, **kwargs):
        boxes = original(*args, **kwargs)
        boxes[:, 5] += 0.1
        return boxes

    monkeypatch.setattr(driver, "from_prediction_to_label_format_batch", moved)


def half_served(monkeypatch):
    """Only the first half of each batch's frustums is served."""
    original = driver.postprocess_packed

    def half(packed, cnt, batch, *args, **kwargs):
        return original(packed, cnt, dict(batch, _real=int(batch["_real"]) // 2), *args,
                        **kwargs)

    monkeypatch.setattr(driver, "postprocess_packed", half)


def unchanged_state(monkeypatch):
    """The step computes its gradients and leaves the parameters as they were."""
    monkeypatch.setattr(train_step, "apply_update", lambda state: None)


def half_batch(monkeypatch):
    """The step sees the first half of each batch: its means are over the rest."""
    original = trainer.to_device

    def half(batch_np, device, *args, **kwargs):
        b = len(batch_np["point_cloud"]) // 2
        cut = {k: tuple(r[:b] for r in v) if k == "refs" else np.asarray(v)[:b]
               for k, v in batch_np.items()}
        return original(cut, device, *args, **kwargs)

    monkeypatch.setattr(trainer, "to_device", half)


def from_the_window(monkeypatch, fault, sound):
    """Runs ``sound(...)`` in set-up's calls of ``run_epoch_train`` and
    ``fault(...)`` from the window's first call (epoch 1) on."""
    original = trainer.run_epoch_train

    def epoch(step, state, accum, loader, index, *args, **kwargs):
        (fault if index >= 1 else sound)()
        return original(step, state, accum, loader, index, *args, **kwargs)

    monkeypatch.setattr(trainer, "run_epoch_train", epoch)


def unchanged_state_in_the_window(monkeypatch):
    """Set-up's steps update the parameters; the window's leave them as they were."""
    update = train_step.apply_update
    from_the_window(
        monkeypatch, lambda: monkeypatch.setattr(train_step, "apply_update", lambda state: None),
        lambda: monkeypatch.setattr(train_step, "apply_update", update))


def stale_batch_in_the_window(monkeypatch):
    """Every step of the window sees the last batch set-up uploaded, as a
    graph captured in set-up that replays its input would."""
    original = trainer.to_device
    last = {"frozen": False}

    def upload(batch_np, device, *args, **kwargs):
        if not last["frozen"]:
            last["batch"] = original(batch_np, device, *args, **kwargs)
        return last["batch"]

    monkeypatch.setattr(trainer, "to_device", upload)
    from_the_window(monkeypatch, lambda: last.update(frozen=True),
                    lambda: last.update(frozen=False))


@pytest.mark.parametrize("cell, fault", [
    (SERVE, altered_answer), (SERVE, half_served),
    (TRAIN, unchanged_state), (TRAIN, half_batch),
    (TRAIN, unchanged_state_in_the_window), (TRAIN, stale_batch_in_the_window)],
    ids=["serve-altered-answer", "serve-half-batch", "train-unchanged-state",
         "train-half-batch", "train-unchanged-state-in-the-window",
         "train-stale-batch-in-the-window"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    tiny.apply(monkeypatch)
    fault(monkeypatch)
    args = argparse.Namespace(workload=cell, seed=2**31 + 23, seconds=0.1, trace=0)
    result = run.run_cell(args, device=torch.device("cpu"), log=lambda m: None)
    assert result["correct"] is False, result["checks"]
