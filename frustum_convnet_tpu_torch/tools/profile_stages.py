"""Per-stage timing of the flagship KITTI inference path on one CUDA card:
``python -m frustum_convnet_tpu_torch.tools.profile_stages [--batch 32] [--dtype bfloat16] [--trace DIR]``

Counterpart of ``tools/profile_stages.py:51-157``, with the same stages and
output lines:

* full forward + decode, and forward only;
* the multi-scale grouping, one launch of kernel 1
  (``group_depth_point_multi``);
* per scale, the select alone (kernel 3, ``query_depth_point``);
* per scale, ``PointNetScale`` grouping for itself (``grouped=None``, kernel 2,
  ``group_depth_point``) followed by its MLP and pool;
* the PointNet MLP stage on precomputed groups;
* decode only.

Each stage is timed with CUDA events: a warm-up, then the best of 3 trials
of 30 back-to-back calls, in place of the JAX tool's on-device ``lax.scan``
loop. The weights are the port's seeded init (seed 3, as the JAX tool's
``PRNGKey(3)``), in eval mode; the batch is ``data/fixtures.make_batch``.
``--trace DIR`` writes a ``torch.profiler`` chrome trace of one full call.
``--dtype`` (float32, bfloat16 or float16) is the model's compute dtype; the
grouping stays float32.
"""

from __future__ import annotations

import argparse
import os

import torch

from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.data.fixtures import make_batch
from frustum_convnet_tpu_torch.engine.test import strict_fp32
from frustum_convnet_tpu_torch.models.det import decode_outputs
from frustum_convnet_tpu_torch.models.net import FrustumConvNet
from frustum_convnet_tpu_torch.ops.select_cuda import (group_depth_point_multi_auto,
                                                       query_depth_point_auto)

ITERS = 30
TRIALS = 3
INIT_SEED = 3


def profile_cfg(cfg_file: str | None = None):
    """The default (flagship det_sample) geometry, or ``cfg_file``'s, with
    xyz-only points, as the JAX tool profiles."""
    cfg = configs.get_default_cfg()
    if cfg_file:
        configs.merge_cfg_from_file(cfg_file, cfg)
        configs.merge_cfg_from_list(["DATA.WITH_EXTRA_FEAT", "False"], cfg)
    else:
        configs.merge_cfg_from_list(
            ["MODEL.FILE", "det_base", "DATA.WITH_EXTRA_FEAT", "False"], cfg)
    return cfg


def build_stages(spec, batch_size: int, device: torch.device,
                 dtype: torch.dtype = torch.float32):
    """[(name, fn)]: each stage as a call with no arguments on ``device``,
    the model computing in ``dtype``."""
    model = FrustumConvNet(spec, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(INIT_SEED))
    model.to(device).eval()
    batch = make_batch(spec, batch=batch_size, seed=0, with_labels=False)
    pts = torch.from_numpy(batch["point_cloud"]).to(device)
    one_hot = torch.from_numpy(batch["one_hot"]).to(device)
    refs = [torch.from_numpy(r).to(device) for r in batch["refs"]]
    xyz = pts[..., :3].contiguous()
    z_points = pts[..., 2].contiguous()
    hh, ks = list(spec.height_half), list(spec.nsamples)
    scales = [getattr(model.feat_net, f"pointnet{i + 1}")
              for i in range(spec.num_scales)]

    def fwd():
        return model(pts, one_hot, refs)

    def full():
        cls_logits, reg = fwd()
        return decode_outputs(spec, cls_logits, reg, refs[1])

    def g_multi():
        return group_depth_point_multi_auto(xyz, refs, hh, ks)

    stages = [("full forward+decode", full), ("forward only", fwd),
              ("multi-scale fused grouping (1 launch)", g_multi)]
    for i in range(spec.num_scales):
        z_ref = refs[i][..., 2].contiguous()
        stages.append((
            f"query cuda scale{i + 1} (M={spec.num_refs[i]},K={ks[i]})",
            lambda z_ref=z_ref, d=hh[i], k=ks[i]:
                query_depth_point_auto(z_points, z_ref, d, k)))
    for i, scale in enumerate(scales):
        stages.append((
            f"pointnet scale{i + 1} self-grouping (M={spec.num_refs[i]},K={ks[i]})",
            lambda scale=scale, ref=refs[i]: scale(pts, ref)))

    with torch.inference_mode():
        groups = g_multi()
        cls_logits, reg = fwd()

    def mlp_stage():
        return [scale(pts, ref, grouped=g)
                for scale, ref, g in zip(scales, refs, groups)]

    stages += [("pointnet MLP stage (grouping precomputed)", mlp_stage),
               ("decode only",
                lambda: decode_outputs(spec, cls_logits, reg, refs[1]))]
    return stages


def time_stage(fn, iters: int = ITERS, trials: int = TRIALS) -> float:
    """Best seconds per call over ``trials`` runs of ``iters`` calls, by CUDA
    events on the current stream, after a warm-up."""
    with torch.inference_mode():
        for _ in range(3):
            fn()
        best = float("inf")
        for _ in range(trials):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / iters)
    return best


def main(argv=None) -> dict:
    """Time every stage on the card; returns {stage name: seconds per call}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="directory for a torch.profiler chrome trace")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "float16"])
    ap.add_argument("--cfg", default=None,
                    help="experiment yaml whose shapes to profile "
                         "(default: flagship det_sample geometry)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profiler times a CUDA card and needs one")
    device = torch.device("cuda")
    strict_fp32()
    spec = configs.get_model_spec(profile_cfg(args.cfg))
    print(f"device: {torch.cuda.get_device_name(device)}, batch {args.batch}, "
          f"{args.dtype}")
    times = {}
    stages = build_stages(spec, args.batch, device, getattr(torch, args.dtype))
    for name, fn in stages:
        best = time_stage(fn)
        times[name] = best
        print(f"{name:42s} {best * 1e3:8.3f} ms/batch   "
              f"{args.batch / best:10.1f} frustums/s")

    if args.trace:
        full = dict(stages)["full forward+decode"]
        os.makedirs(args.trace, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.inference_mode(), torch.profiler.profile(activities=acts) as prof:
            full()
            torch.cuda.synchronize()
        path = os.path.join(args.trace, "profile_stages.json")
        prof.export_chrome_trace(path)
        print("trace written to", path)

    total = times["full forward+decode"]
    print(f"\nbench-equivalent total: {total * 1e3:.2f} ms/batch = "
          f"{args.batch / total:.0f} frustums/s")
    return times


if __name__ == "__main__":
    main()
