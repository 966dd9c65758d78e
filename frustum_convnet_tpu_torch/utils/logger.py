"""Logging: file+console logger and a lightweight scalar writer.

``get_logger`` mirrors the reference's dual-sink logger
(reference `utils/utils.py:70-82`). ``ScalarWriter`` replaces the TF1
TensorBoard wrapper (`utils/logger.py:12-72`) with two sinks: a greppable
JSONL scalar log under ``<output_dir>/tb_logger/<tag>.jsonl`` AND real
TensorBoard event files under ``<output_dir>/tb_logger/<tag>/`` (the
reference's ``tb_logger/{train,val}`` layout), written by the
dependency-free encoder in :mod:`frustum_convnet_tpu_torch.utils.tfevents`.
"""

from __future__ import annotations

import json
import logging
import os
import time


def get_logger(log_file: str | None = None, name: str = "frustum_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    # own handlers only — without this, a root logger configured by the
    # embedding script (logging.basicConfig) would emit every line twice
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class ScalarWriter:
    def __init__(self, output_dir: str, tag: str):
        from frustum_convnet_tpu_torch.utils.tfevents import TFEventWriter

        d = os.path.join(output_dir, "tb_logger")
        os.makedirs(d, exist_ok=True)
        self.path = os.path.join(d, f"{tag}.jsonl")
        self._f = open(self.path, "a")
        self._events = TFEventWriter(os.path.join(d, tag))

    def scalar_summary(self, key: str, value: float, step: int):
        ts = time.time()
        self._f.write(json.dumps(
            {"step": step, "key": key, "value": float(value), "ts": ts}) + "\n")
        self._events.scalar(key, value, step, wall_time=ts)

    def scalars(self, values: dict, step: int):
        for k, v in values.items():
            self.scalar_summary(k, v, step)
        self._f.flush()
        self._events.flush()

    def image_summary(self, key: str, images, step: int):
        """A list of images logged as ``key/i`` (event file only; images do
        not fit the JSONL sink). Reference `utils/logger.py:24-43`."""
        for i, img in enumerate(images):
            self._events.image(f"{key}/{i}", img, step)
        self._events.flush()

    def histo_summary(self, key: str, values, step: int, bins: int = 1000):
        """Histogram of a tensor (event file only).
        Reference `utils/logger.py:46-72`."""
        self._events.histogram(key, values, step, bins=bins)
        self._events.flush()

    def close(self):
        self._f.close()
        self._events.close()
