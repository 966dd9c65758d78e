"""Throughput of every supported experiment config on one CUDA card:
``python -m frustum_convnet_tpu_torch.tools.bench_models [--iters 30] [--batches 32,256] [--train] [--dtype bfloat16] [--only refine,people] [--device cuda]``

Counterpart of ``tools/bench_models.py``. The port's ``bench`` reports the
flagship (det_sample). This sweeps all five reference configs
(``cfgs/*.yaml`` — KITTI car/people stage 1, car/people refinement,
SUN-RGBD) at their own reference shapes (NUM_SAMPLES, strides, MAX_DEPTH)
and prints a frustums/sec table, timed as the bench times (CUDA events over
back-to-back eager calls, best of ``bench.TRIALS``). ``--train`` benches the
full training step (fwd + grads + adam + BN update, each trial from the
initial state) instead of inference. A row prints as each config finishes,
then the markdown table. ``--device`` defaults to ``cuda`` and raises
without a card; ``--device cpu`` runs on the host clock.
"""

from __future__ import annotations

import argparse
import os

import torch

from frustum_convnet_tpu_torch import bench
from frustum_convnet_tpu_torch.engine.test import strict_fp32
from frustum_convnet_tpu_torch.utils.timing import card_name

CFGS = tuple(os.path.join(bench.ROOT, "cfgs", name) for name in (
    "det_sample.yaml",
    "det_sample_people.yaml",
    "refine_car.yaml",
    "refine_people.yaml",
    "det_sample_sunrgbd.yaml",
))


def main(argv=None) -> list:
    """Returns the rows: [(config name, shapes, {batch: frustums/sec})]."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--batches", default="32,256")
    ap.add_argument("--train", action="store_true",
                    help="bench the full training step instead of inference")
    ap.add_argument("--dtype", default="",
                    help="compute dtype override (e.g. bfloat16 — the "
                         "supported batch-32 train recipe)")
    ap.add_argument("--only", default="",
                    help="comma-separated config-name substrings to bench "
                         "(e.g. refine,people); empty = all five")
    ap.add_argument("--device", default="cuda",
                    help="torch device to time (cuda, cuda:N; cpu on the host clock)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; pass --device cpu to run on the CPU")
    strict_fp32()
    batches = tuple(int(x) for x in args.batches.split(","))
    cfgs = CFGS
    if args.only:
        pats = [p.strip() for p in args.only.split(",") if p.strip()]
        cfgs = tuple(c for c in CFGS
                     if any(p in os.path.basename(c) for p in pats))

    # an override of the cfg's compute dtype (e.g. the bf16 train recipe)
    dtype = bench.DTYPES[args.dtype] if args.dtype else None

    print(f"device: {card_name(device)}", flush=True)
    rows = []
    for cfg_file in cfgs:
        name = os.path.splitext(os.path.basename(cfg_file))[0]
        rates = {}
        for bsz in batches:
            spec, _, rates[bsz] = bench.bench_secondary_config(
                name, bsz, args.iters, train=args.train, dtype=dtype, device=device)
        shape = (f"N={spec.num_points} scales={spec.num_scales} "
                 f"sections={sum(spec.num_refs)}")
        rows.append((name, shape, rates))
        rate_s = "  ".join(f"b{b}: {r:8.0f} f/s" for b, r in rates.items())
        print(f"{name:24s} {shape:34s} {rate_s}", flush=True)

    print("\n| config | shapes | " +
          " | ".join(f"batch {b}" for b in batches) + " |")
    print("|---|---|" + "---|" * len(batches))
    for name, shape, rates in rows:
        print(f"| {name} | {shape} | " +
              " | ".join(f"{rates[b]:.0f}" for b in batches) + " |")
    return rows


if __name__ == "__main__":
    main()
