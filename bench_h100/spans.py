"""The device's idle time in a traced stretch, charged to the program's spans.

The program's serving and training loops wrap their host work in named spans
(``frustum_convnet_tpu_torch/utils/trace.py``): while ``torch.profiler``
records, each is a ``user_annotation`` named ``serve.*`` or ``train.*`` on
the thread that runs the loop, on the same timeline as the device's
kernels and copies. ``idle_by_span`` takes the Chrome trace of a stretch
(``bench_h100.trace.Traced``'s) and charges every instant of the stretch at
which the device ran nothing (no kernel, copy or set) to the innermost
program span open at that instant on that thread, by exact overlap, or to
``none`` where no program span is open. The charges sum to the stretch's
length less the device's busy time, as ``trace.summarize`` computes both.

    python3 -m bench_h100.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as ``python3 -m bench_h100.run --trace 1`` does (the same
set-up, window, traced stretch and check), with the trace's reduction also
charging its idle to the spans, and prints the run's result line with
``spans``: ``idle_s`` (the charges), ``trace_totals`` (each program span's
entries and seconds in the stretch, from the trace), ``idle_pct`` (each
charge over the stretch's length, in %) and ``unattributed_pct`` (the share
of the idle charged to ``none`` or to the call's root span itself).
"""

from __future__ import annotations

import argparse
import bisect
import json

from bench_h100 import trace

PREFIXES = ("serve.", "train.")
ROOTS = ("serve.call", "train.epoch")
NONE = "none"


def _window(events: list):
    """(lo, hi, (pid, tid)) of the stretch: its ``bench.traced_window`` span,
    else the device's first and last interval (as ``summarize`` takes it)."""
    window = [e for e in events if e.get("name") == trace.WINDOW_SPAN]
    if window:
        w = window[0]
        return w["ts"], w["ts"] + w["dur"], (w.get("pid"), w.get("tid"))
    device = [e for e in events if e.get("cat") in trace.DEVICE_CATS]
    if not device:
        return None, None, None
    return (min(e["ts"] for e in device), max(e["ts"] + e["dur"] for e in device), None)


def _idle_gaps(events: list, lo: float, hi: float) -> list:
    """The stretch's instants with nothing on the device, as sorted
    disjoint (t0, t1), the gaps ``summarize`` finds."""
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in trace.DEVICE_CATS)
    gaps, cursor = [], lo
    for t0, t1 in device:
        if t0 > cursor:
            gaps.append((cursor, min(t0, hi)))
        cursor = max(cursor, t1)
        if cursor >= hi:
            break
    if hi > cursor:
        gaps.append((cursor, hi))
    return [g for g in gaps if g[1] > g[0]]


def program_spans(events: list, thread=None) -> list:
    """The program's spans, (t0, t1, name), on ``thread`` ((pid, tid); any
    thread when None)."""
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith(PREFIXES)
            and (thread is None or (e.get("pid"), e.get("tid")) == thread)]


def idle_by_span(trace_json) -> dict:
    """{program span name or ``none``: device-idle seconds}, each idle
    instant of the stretch charged to the innermost program span over it on
    the loop's thread (the one that opened ``bench.traced_window``)."""
    events = [e for e in (trace_json["traceEvents"] if isinstance(trace_json, dict)
                          else trace_json) if e.get("ph") == "X"]
    lo, hi, thread = _window(events)
    if lo is None:
        return {}
    gaps = _idle_gaps(events, lo, hi)
    starts = [g[0] for g in gaps]
    cum = [0.0]
    for g0, g1 in gaps:
        cum.append(cum[-1] + (g1 - g0))

    def idle_before(t: float) -> float:
        i = bisect.bisect_right(starts, t)
        return cum[i] - max(0.0, gaps[i - 1][1] - t) if i else 0.0

    def idle_in(t0: float, t1: float) -> float:
        return idle_before(t1) - idle_before(t0)

    # on one thread the spans nest: each span's own charge is the idle
    # under it less the idle under its children
    charge = {NONE: cum[-1]}
    stack: list = []  # (t1, name) of the open spans, innermost last
    for t0, t1, name in sorted(program_spans(events, thread), key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= t0:
            stack.pop()
        own = idle_in(t0, t1)
        charge[name] = charge.get(name, 0.0) + own
        parent = stack[-1][1] if stack else NONE
        charge[parent] -= own
        stack.append((t1, name))
    return {k: max(v, 0.0) * 1e-6 for k, v in charge.items()}


def trace_totals(trace_json) -> dict:
    """{program span name: {"n": entries, "s": seconds}} on the loop's
    thread, as the trace holds them."""
    events = [e for e in (trace_json["traceEvents"] if isinstance(trace_json, dict)
                          else trace_json) if e.get("ph") == "X"]
    _, _, thread = _window(events)
    totals: dict = {}
    for t0, t1, name in program_spans(events, thread):
        entry = totals.setdefault(name, {"n": 0, "s": 0.0})
        entry["n"] += 1
        entry["s"] += (t1 - t0) * 1e-6
    return totals


def account(idle: dict, window_s: float) -> dict:
    """Each charge over the stretch's length in %, and the share of the idle
    charged to ``none`` or to a root span itself."""
    total = sum(idle.values())
    unattributed = idle.get(NONE, 0.0) + sum(idle.get(r, 0.0) for r in ROOTS)
    return {"idle_pct": {k: 100.0 * v / window_s for k, v in idle.items()},
            "unattributed_pct": 100.0 * unattributed / total if total > 0 else 0.0}


def main(argv=None, device=None, log=None) -> dict:
    from bench_h100 import run

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    args.trace = 1
    summarize, seen = trace.summarize, {}

    def summarize_with_spans(events, window_s, **kw):
        summary = summarize(events, window_s, **kw)
        seen.update(idle_s=idle_by_span(events), trace_totals=trace_totals(events),
                    window_s=window_s)
        return summary

    trace.summarize = summarize_with_spans
    try:
        result = run.run_cell(args, device=device, log=log or run.log)
    finally:
        trace.summarize = summarize
    if seen:
        result["spans"] = {"idle_s": seen["idle_s"], "trace_totals": seen["trace_totals"],
                           **account(seen["idle_s"], seen["window_s"])}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
