"""The device trace of a stretch of a run, and what the metrics read from it.

``Traced`` wraps ``torch.profiler`` (host ops and CUDA activity) around a
stretch that starts and ends with the device idle (a synchronize on both
sides), exports the trace as Chrome JSON into a temporary directory and
reduces it to a ``Summary``:

* ``busy_s``: the union of the device's kernel, copy and set intervals;
  ``window_s``: the stretch's length on the host clock;
* per kernel name, its launches and total device seconds;
* the longest idle gaps between device intervals, each named by the
  innermost host event (a harness span, an op, a runtime call) that covers
  its middle, or ``host`` where none does.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.traced_window"


@dataclass
class Summary:
    busy_s: float
    window_s: float
    kernels: dict  # name -> [launches, device seconds]
    device_ops: list  # [[name, seconds]], most time first
    idle_gaps: list  # [[host activity, seconds]], longest first
    extra: dict = field(default_factory=dict)

    def kernel(self, fragment: str):
        """(launches, device seconds) of the kernels whose name holds
        ``fragment``."""
        hits = [v for k, v in self.kernels.items() if fragment in k]
        return sum(h[0] for h in hits), sum(h[1] for h in hits)


class Traced:
    """``with Traced(device) as t: ...`` then ``t.summary``; ``t.overhead_s``
    is the host time the profiler's start, export and reduction took, which
    a rate leaves out."""

    def __init__(self, device):
        self.device = device
        self.summary: Summary | None = None
        self.overhead_s = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        _sync(self.device)
        t = time.perf_counter()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        self.overhead_s += self._t0 - t
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        t = time.perf_counter()
        window_s = t - self._t0
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)
            self.summary = summarize(events, window_s)
        self._prof = None
        self.overhead_s += time.perf_counter() - t
        return False


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def summarize(trace: dict, window_s: float, top: int = 10) -> Summary:
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = [e for e in events if e.get("ph") == "X"]
    window = [e for e in spans if e.get("name") == WINDOW_SPAN]
    lo = min((e["ts"] for e in window), default=None)
    hi = max((e["ts"] + e["dur"] for e in window), default=None)
    device = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
                     if e.get("cat") in DEVICE_CATS), key=lambda x: x[0])
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
            if e.get("cat") in HOST_CATS]
    if lo is None and device:
        lo, hi = device[0][0], device[-1][1]
    kernels: dict = defaultdict(lambda: [0, 0.0])
    for t0, t1, name in device:
        kernels[name][0] += 1
        kernels[name][1] += (t1 - t0) * 1e-6
    busy, gaps, cursor = 0.0, [], lo
    for t0, t1, _ in device:
        if cursor is not None and t0 > cursor:
            gaps.append((cursor, t0))
        start = t0 if cursor is None else max(t0, cursor)
        if t1 > start:
            busy += (t1 - start) * 1e-6
        cursor = t1 if cursor is None else max(cursor, t1)
    if hi is not None and cursor is not None and hi > cursor:
        gaps.append((cursor, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[_host_activity(host, (g0 + g1) / 2), (g1 - g0) * 1e-6]
             for g0, g1 in gaps[:top]]
    ops = sorted(([k, v[1]] for k, v in kernels.items()), key=lambda kv: -kv[1])
    return Summary(busy_s=busy, window_s=window_s, kernels=dict(kernels),
                   device_ops=ops[:top], idle_gaps=named)


def _host_activity(host, t: float) -> str:
    best = None
    for t0, t1, name in host:
        if t0 <= t <= t1 and name != WINDOW_SPAN and (best is None or t1 - t0 < best[0]):
            best = (t1 - t0, name)
    return best[1] if best else "host"
