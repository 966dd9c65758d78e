"""Named spans of the serving and training host work, on the profiler's clock.

``with span(name, totals): ...`` adds the block's host seconds
(``time.perf_counter``) and one entry to ``totals[name]`` =
``{"n": entries, "s": seconds}``. While a ``torch.profiler`` profile is
recording, the span is also a ``record_function(name)``: a
``user_annotation`` in the profiler's trace, on the same timeline as the
device's kernels and copies, nested in the spans around it. With no profile
recording, a span costs two clock reads, one check of the profiler's state
and a dict update: no dispatcher call, no synchronize, no copy. The
profiler is the only switch and the only exporter.

``engine.test.run_test`` opens the spans ``serve.*``;
``engine.train.run_epoch_train`` and ``parallel.train_step`` open
``train.*``. Each call returns its totals in its stats under ``"spans"``.
"""

from __future__ import annotations

import time

import torch


class span:
    """Context manager: the block's host seconds and one entry go to
    ``totals[name]`` (when ``totals`` is not None); the block is a profiler
    annotation when a profile is recording as it starts."""

    __slots__ = ("name", "totals", "t0", "record")

    def __init__(self, name: str, totals: dict | None):
        self.name = name
        self.totals = totals

    def __enter__(self):
        self.record = None
        if torch.autograd._profiler_enabled():
            self.record = torch.profiler.record_function(self.name)
            self.record.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        # a span entered with the profiler off opened no annotation to close
        if self.record is not None:
            self.record.__exit__(*exc)
            self.record = None
        if self.totals is not None:
            entry = self.totals.get(self.name)
            if entry is None:
                self.totals[self.name] = {"n": 1, "s": seconds}
            else:
                entry["n"] += 1
                entry["s"] += seconds
        return False


def spanned(iterable, name: str, totals: dict | None):
    """The items of ``iterable``, each ``next()`` on it inside a span (the
    last, which ends the iteration, included)."""
    it = iter(iterable)
    while True:
        with span(name, totals):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item
