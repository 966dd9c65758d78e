"""Runs one cell of the benchmark once and prints its result as the last line.

    python3 -m bench_h100.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``workloads`` in ``BENCHMARK.json``)
names a configuration (``bench_h100/configs/<name>.json``) and a traffic mix
(``bench_h100/traffic/<name>.json``); the traffic's ``job`` names the module
that drives it (``bench_h100/<job>.py``: ``serve`` or ``train`` so far), and
the cell's limits are ``bench_h100/limits/<workload>.json``. With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, each read by
``bench_h100/metrics/<metric>.py``.

A job module is all the harness knows of a job; a new job is a new module:

- ``run(job)``: set-up, window and check of one run; a dict with
  ``end_to_end``, ``numbers`` (the compared numbers, by the limits' names),
  ``attempted``, ``failed``, ``device`` and ``ctx`` (what the metrics read);
- ``TINY``: overrides of the traffic for the CPU tests' size
  (``bench_h100/tests/tiny.py``), and ``SMALL`` for the card control test's
  (``test_h100bench_control.py``); a ``cfg`` in them merges key by key;
- ``readings(job, control)``: the compared numbers of the stretch of the
  timed path the check reads (``program``) and, with ``control``, the
  control's and the faults' (``bench_h100.control``).

Serving jobs share ``serve.window``: the warm calls, the timed calls, the
traced call, the release of the program, the check and the result. A family
of frustums hands it a ``serve.Family``: its set-up, how a call's detections
become the arrays its check reads, that check, the traced call's kernel-1
bound and the counters of a call's stats (``serve.KITTI`` is KITTI's).

The run exits with a code other than 0 and prints no result when no CUDA
card is visible, when the card count is below the cell's, and when, after
the window, the process holds a module of JAX or of the JAX package. Its
last lines on standard error, and the result's last key, give each number
compared beside its limit.
"""

from __future__ import annotations

import time

T_START = time.time()  # set-up is counted from here, before torch is imported

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

GUARDED = ("jax", "jaxlib", "flax", "optax", "frustum_convnet_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def guarded_modules() -> list:
    """Modules of JAX or of the JAX package in this process, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(GUARDED))


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_metric(name: str, ctx: dict):
    """The value of per-layer metric ``name`` from its reader, or None."""
    from bench_h100 import common

    path = os.path.join(common.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("bench_h100_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def job_module(traffic: dict):
    """The module that drives a traffic mix: ``bench_h100.<its job>``."""
    return importlib.import_module(f"bench_h100.{traffic['job']}")


def make_job(args, device=None, log=log) -> tuple:
    """(BENCHMARK.json, the cell, the job the traffic's module runs). A
    ``device`` given skips the look for a card (the tests run on the CPU)."""
    from bench_h100 import common

    bench = common.load_json(os.pardir, "BENCHMARK.json")
    cell = cell_of(bench, args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible")
        if torch.cuda.device_count() < cell["chips"]:
            raise RuntimeError(f"{cell['chips']} cards asked, "
                               f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
        log(f"[setup] the card is ready at {time.time() - T_START:.2f} s")
    traffic = common.load_json("traffic", f"{cell['traffic']}.json")
    job = {"config": common.load_json("configs", f"{cell['config']}.json"),
           "traffic": traffic, "device": device, "log": log, "seed": args.seed,
           "seconds": args.seconds, "trace": bool(args.trace), "chips": cell["chips"],
           "t_start": getattr(args, "t_start", T_START)}
    return bench, cell, job


def run_cell(args, device=None, log=log) -> dict:
    """Set-up, window and check of one cell; returns the result's dict."""
    from bench_h100 import common

    bench, cell, job = make_job(args, device, log)
    out = job_module(job["traffic"]).run(job)
    limits = common.load_json("limits", f"{args.workload}.json")
    checks = {k: {"value": out["numbers"][k], "limit": v} for k, v in limits.items()}
    log("[check] readings " + json.dumps(out["numbers"]))
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if applies(m, args.workload):
                value = read_metric(m["name"], out["ctx"])
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, args.workload) and m["name"] in out["end_to_end"]:
                metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                      "unit": units[m["name"]]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": out["device"]}
    summary = out["ctx"].get("trace")
    if args.trace and summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    for name, c in checks.items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result = run_cell(args)
    except RuntimeError:
        log(traceback.format_exc())
        return 2
    found = guarded_modules()
    if found:
        log(f"error: the process holds {', '.join(found)} after the window")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
