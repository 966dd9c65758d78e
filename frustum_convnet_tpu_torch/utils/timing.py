"""Timing helpers shared by the bench and the profilers: the best seconds a
call over back-to-back calls (CUDA events on the card, the host clock on
the CPU), and the card's name and power limit."""

from __future__ import annotations

import subprocess
import time

import torch


def time_calls(fn, device: torch.device, iters: int, trials: int,
               before_trial=None) -> float:
    """Best seconds a call over ``trials`` runs of ``iters`` calls after a
    warm-up call: CUDA events on the card, the host clock on the CPU.
    ``before_trial()``, when given, runs untimed before each trial."""
    fn()
    best = float("inf")
    for _ in range(trials):
        if before_trial is not None:
            before_trial()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            sec = time.perf_counter() - t0
        best = min(best, sec / iters)
    return best


def card_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    torch device name where ``nvidia-smi`` cannot be read), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)
