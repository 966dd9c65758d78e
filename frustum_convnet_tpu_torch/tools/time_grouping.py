"""Times the grouping kernels on one CUDA card, beside their bounds.

    python3 frustum_convnet_tpu_torch/tools/time_grouping.py [--tree DIR] [--out FILE]

Run as a script (not with ``-m``), so that ``--tree`` can point it at another
checkout of the repository, for example the parent commit unpacked with
``git archive`` into the gitignored ``_archive/``: the script then imports
that tree's ``frustum_convnet_tpu_torch`` and builds that tree's kernels. To
compare two trees on one card, run both in one command, in turns (parent,
change, change, parent).

At the flagship shapes (``cfgs/det_sample.yaml``, inputs from
``ops/grouping_cases.flagship_case``) it times kernel 1 (every scale in one
launch) at B = 32, 64 and 256, kernels 2 (one scale) and 3 (select only)
at B = 256 on scales 1 (M=280, K=32) and 4 (M=35, K=128), and kernel 3 at
the stage profiler's B = 32 on scale 1. It then times kernel 1 at B = 32 on
a batch of each other family's provider (``grouping_cases.family_datasets``:
refine car, refine people, people and SUN-RGBD, over synthetic splits
written into a temporary directory):

* ``alone``: the kernel's own device time, the mean over 50 launches of the
  kernels that ``torch.profiler`` names after it;
* ``calls``: 200 back-to-back calls of the Python wrapper between two CUDA
  events, which includes whatever of the wrapper's host time the card does
  not hide;
* ``plain``: the kernel's plain PyTorch version
  (``ops/query_depth_point``) on the same tensors on the card, 10 calls
  between two CUDA events;
* ``bound``: ``kernel_bound`` of the same inputs, and ``share`` = bound /
  alone.

Prints one line per measurement and, last, one JSON object with all of them,
the card's name and power limit; ``--out`` also writes that object to FILE.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
# H100 SXM float32 instructions outside the tensor cores: the data sheet's
# 67 TFLOP/s counts each fused multiply-add as two operations, and the
# subtracts and compares counted here are one instruction each
FP32_OPS_PER_S = 67e12 / 2
KERNEL_NAMES = {"group_depth_point_multi": "group_depth_point_kernel",
                "group_depth_point": "group_depth_point_kernel",
                "query_depth_point": "query_depth_point_kernel"}


def selected_hits(z_points, z_ref, dis_z: float, k: int) -> int:
    """Hits an exact select takes on these inputs: the sum over sections of
    min(hits, K), which is the sum of its cnt. z_points (B, N), z_ref (B, M)."""
    total = 0
    for b in range(0, z_points.shape[0], 32):  # in slices, to bound the memory
        zp, zr = z_points[b:b + 32], z_ref[b:b + 32]
        hits = ((zp[:, None, :] - zr[:, :, None]).abs() < dis_z).sum(dim=-1)
        total += int(hits.clamp(max=k).sum())
    return total


def kernel_bound(name: str, points, refs, dzs, ks) -> dict:
    """The least time the card could take for one call of kernel ``name`` on
    these inputs: the larger of its bytes (each input read once, each
    output written once) over the HBM rate and its float32 operations over
    the float32 instruction rate. The operations are what any exact select
    must do with these inputs, whatever it skips: a subtract and a compare
    per selected hit (the sum of cnt), and for the grouping modes three
    subtracts per slot. A select that tests every (section, point) pair
    does more; a prefilter need not.
    ``points`` (B, N, C) and ``refs`` [(B, M_i, 3)] are tensors; for
    kernel 3 the inputs are their depth channels."""
    b, n, c = points.shape
    ms = [int(r.shape[1]) for r in refs]
    hits = sum(selected_hits(points[..., 2], r[..., 2], d, int(k))
               for r, d, k in zip(refs, dzs, ks))
    slots = b * sum(m * int(k) for m, k in zip(ms, ks))
    if name == "query_depth_point":
        moved = 4 * (b * n + b * sum(ms) + slots + b * sum(ms))
        ops = 2 * hits
    else:
        moved = 4 * (b * n * c + 3 * b * sum(ms) + slots * c + b * sum(ms))
        ops = 2 * hits + 3 * slots
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved, "operations": ops}


def cuda_time_ms(fn, iters: int = 200) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` back-to-back calls
    on the current stream, between two CUDA events, after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alone_ms(fn, kernel_name: str, iters: int = 50, attempts: int = 3) -> float:
    """Mean device time of the kernels named ``kernel_name`` over ``iters``
    calls, from ``torch.profiler``. A trace that misses launches (seen now
    and then on the card) is taken again, up to ``attempts`` times; then
    it raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel_name in e.key]
        times = [getattr(e, "device_time_total", None) or e.cuda_time_total for e in events]
        counts = [e.count for e in events]
        if times and sum(counts) == iters:
            return sum(times) / sum(counts) / 1e3
    raise RuntimeError(f"the profiler saw {sum(counts)} launches of "
                       f"{kernel_name} in {iters} calls, {attempts} times")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="checkout whose frustum_convnet_tpu_torch is timed (default: this one)")
    p.add_argument("--out", default="", help="also write the JSON object here")
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("time_grouping measures on a CUDA card; none is visible")
    from frustum_convnet_tpu_torch import configs
    from frustum_convnet_tpu_torch.ops import grouping_cases, select_cuda
    from frustum_convnet_tpu_torch.ops import query_depth_point as plain

    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(os.path.join(tree, "cfgs", "det_sample.yaml"), cfg)
    spec = configs.get_model_spec(cfg)
    dev = torch.device("cuda", 0)
    rows = []

    def measure(name, label, fn, plain_fn, points, refs, dzs, ks):
        alone = alone_ms(fn, KERNEL_NAMES[name])
        calls = cuda_time_ms(fn)
        plain = cuda_time_ms(plain_fn, iters=10)
        bound = kernel_bound(name, points, refs, dzs, ks)
        row = {"kernel": name, "case": label, "alone_ms": alone, "calls_ms": calls,
               "plain_ms": plain, "share": bound["bound_ms"] / alone, **bound}
        rows.append(row)
        print(f"[time] {name} {label}: alone {alone:.4f} ms, calls {calls:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}), share {row['share']:.1%}", flush=True)

    inputs = {}
    for batch in (32, 64, 256):
        pts, refs, dzs, ks = grouping_cases.flagship_case(spec, batch=batch)
        t_pts = torch.from_numpy(pts).to(dev)
        t_refs = [torch.from_numpy(r).to(dev) for r in refs]
        inputs[batch] = (t_pts, t_refs, dzs, ks)
        measure("group_depth_point_multi", f"B={batch}",
                lambda: select_cuda.group_depth_point_multi_cuda(t_pts, t_refs, dzs, ks),
                lambda: plain.group_depth_point_multi(t_pts, t_refs, dzs, ks),
                t_pts, t_refs, dzs, ks)
    with tempfile.TemporaryDirectory(prefix="time_grouping-") as work:
        families = grouping_cases.family_datasets(os.path.join(tree, "cfgs"), work)
    for family, (fspec, dataset) in families.items():
        f_pts, f_refs, f_dzs, f_ks = grouping_cases.provider_case(fspec, dataset, 32)
        f_pts = torch.from_numpy(f_pts).to(dev)
        f_refs = [torch.from_numpy(r).to(dev) for r in f_refs]
        label = (f"{family} B=32 (N={fspec.num_points}, M={'/'.join(map(str, fspec.num_refs))}, "
                 f"K={'/'.join(map(str, f_ks))})")
        measure("group_depth_point_multi", label,
                lambda: select_cuda.group_depth_point_multi_cuda(f_pts, f_refs, f_dzs, f_ks),
                lambda: plain.group_depth_point_multi(f_pts, f_refs, f_dzs, f_ks),
                f_pts, f_refs, f_dzs, f_ks)
    # kernels 2 and 3 at B=256 on scales 1 and 4; kernel 3 also at the
    # profiler's B=32 on scale 1
    for batch, i, kernels in ((256, 0, ("group_depth_point", "query_depth_point")),
                              (256, 3, ("group_depth_point", "query_depth_point")),
                              (32, 0, ("query_depth_point",))):
        t_pts, t_refs, dzs, ks = inputs[batch]
        z_points = t_pts[..., 2].contiguous()
        ref, d, k = t_refs[i], dzs[i], ks[i]
        z_ref = ref[..., 2].contiguous()
        label = f"B={batch} scale {i + 1} (M={ref.shape[1]}, K={k})"
        calls = {"group_depth_point":
                 (lambda: select_cuda.group_depth_point_cuda(t_pts, ref, d, k),
                  lambda: plain.group_depth_point(t_pts, ref, d, k)),
                 "query_depth_point":
                 (lambda: select_cuda.query_depth_point_cuda(z_points, z_ref, d, k),
                  lambda: plain.query_depth_point(z_points, z_ref, d, k))}
        for name in kernels:
            measure(name, label, *calls[name], t_pts, [ref], [d], [k])
    with open(os.path.join(tree, select_cuda.KERNEL_SOURCE), "rb") as f:
        source = hashlib.sha256(f.read()).hexdigest()[:12]
    result = {"tree": args.tree, "kernel_source_sha256": source, "card": card(),
              "device": torch.cuda.get_device_name(0), "rows": rows}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
