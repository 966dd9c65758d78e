"""Readings that the limits of a cell's compared numbers are set from.

    python3 -m bench_h100.control --workload <name> --seeds 1,2,...,12 [--control 3] [--out FILE]

For each seed it runs the cell's set-up and the stretch of the timed path
that the check reads (serving: one call of ``run_test`` over the whole
split; training: one call of ``run_epoch_train`` over the checked steps),
frees the program's state and compares with the reference, as a run does.
For the first ``--control`` seeds it also reads the control: the reference
computed in TF32, the precision next below the configuration's float32
with TF32 off, put in the program's place (serving: its detections by the
serving rule; training: its steps); for a training cell also the steps
with half of each batch left out, the mean taken over the rest. Prints a JSON line a seed and, last, the largest
program reading and the smallest control and fault readings of each number.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from bench_h100 import run as bench_run


def _half(batch: dict) -> dict:
    b = len(batch["point_cloud"]) // 2
    return {k: tuple(r[:b] for r in v) if k == "refs" else v[:b] for k, v in batch.items()}


def readings(args, seed: int, control: bool, device=None) -> dict:
    job_args = argparse.Namespace(workload=args.workload, seed=seed, seconds=0, trace=0)
    _, _, job = bench_run.make_job(job_args, device)
    device = job["device"]
    out = {"seed": seed}
    if job["traffic"]["job"] == "serve":
        from bench_h100 import serve
        from bench_h100.reference import serve as ref_serve

        s = serve.prepare(job)
        det, _ = s["serve"]()
        serve.release(s, device)
        served = ref_serve.served_arrays(det, s["frustum_of"])
        out["program"], table, _ = serve.check(s, [served], device)
        if control:
            ctl = ref_serve.section_table(s["params"], s["spec"], s["inputs"], device,
                                          allow_tf32=True)
            dets = ref_serve.rule_detections(ctl, s["rec"]["id"], s["rec"]["box2d"])
            gaps = ref_serve.compare(ref_serve.served_arrays(dets, s["frustum_of"]), table)
            out["control"] = {k: gaps[k] for k in out["program"]}
    else:
        from bench_h100 import train
        from bench_h100.reference import train as ref_train

        s = train.prepare(job)
        train.call(s, train.ReplayLoader(s["batches"][:train.CHECKED_STEPS]), 0)
        program = s["recorder"].readings(s["names"])
        train.release(s, device)
        out["program"], ref = train.check(s, program, device)
        if control:
            cfg, first = s["cfg"], s["batches"][:train.CHECKED_STEPS]
            lr, wd = cfg.TRAIN.BASE_LR, cfg.TRAIN.WEIGHT_DECAY
            ctl = ref_train.steps(s["params"], s["names"], s["spec"], first, lr, wd, device,
                                  allow_tf32=True)
            out["control"] = ref_train.compare(ref_train.readings(ctl), ref)
            half = ref_train.steps(s["params"], s["names"], s["spec"],
                                   [_half(b) for b in first], lr, wd, device)
            out["half_batch"] = ref_train.compare(ref_train.readings(half), ref)
    return out


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
    for kind in ("control", "half_batch"):
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary[f"{kind}_min"] = {k: min(g[k] for g in got) for k in got[0]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
