"""Readings that the limits of a cell's compared numbers are set from.

    python3 -m bench_h100.control --workload <name> --seeds 1,2,...,12 [--control 3] [--out FILE]

For each seed the ``readings`` of the cell's job module
(``bench_h100/<job>.py``) run the cell's set-up and the stretch of the
timed path that the check reads (serving: one call of ``run_test`` over the
whole split; training: one call of ``run_epoch_train`` over the checked
steps), free the program's state and compare with the reference, as a run
does. For the first ``--control`` seeds they also read the control: the
reference computed in TF32, the precision next below the configuration's
float32 with TF32 off, put in the program's place (serving: its detections
by the serving rule; training: its steps); for a training cell also the
steps with half of each batch left out, the mean taken over the rest.
Prints a JSON line a seed and, last, the largest program reading and the
smallest control and fault readings of each number.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from bench_h100 import run as bench_run


def readings(args, seed: int, control: bool, device=None) -> dict:
    """One seed's readings, by the ``readings`` of the job module the cell's
    traffic names."""
    job_args = argparse.Namespace(workload=args.workload, seed=seed, seconds=0, trace=0)
    _, _, job = bench_run.make_job(job_args, device)
    return {"seed": seed, **bench_run.job_module(job["traffic"]).readings(job, control)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--control", type=int, default=3,
                        help="read the control on this many of the first seeds")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    rows = []
    for i, seed in enumerate(int(x) for x in args.seeds.split(",")):
        rows.append(readings(args, seed, i < args.control))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload,
               "program_max": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    for kind in dict.fromkeys(k for r in rows for k in r if k not in ("seed", "program")):
        got = [r[kind] for r in rows if kind in r]
        summary[f"{kind}_min"] = {k: min(g[k] for g in got) for k in got[0]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
