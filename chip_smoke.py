#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which raises on failure (exit code != 0, no result line):

1. device: a CUDA card must be visible; prints its name and power limit;
2. build: compiles ``frustum_convnet_tpu_torch/csrc/group_depth_point.cu``;
3. kernel: the CUDA grouping kernel against its plain PyTorch version on the
   card, bit for bit (grouped and cnt), at the flagship shapes (B=32, 64,
   256 and 1024: the trainer's batch, the serving group's, the timed one
   and the bench's largest) and on every edge case of
   ``ops/grouping_cases``; timed with CUDA events at B=32, 64, 256 and
   1024 beside its bound (``tools/time_grouping.kernel_bound``),
   and at B=256 in turns with the plain version (plain, kernel, kernel,
   plain);
4. model: the flagship forward at batch 8 of the served split, on the card
   against the port on the CPU with the same seeded weights, atol/rtol 1e-4
   (TF32 off). The weights are the port's seeded init with perturbed
   BatchNorm statistics and a cls head fitted to the split's label-rule
   foreground (``fit_cls_head``);
5. driver: ``frustum_convnet_tpu_torch.engine.test.main`` on
   ``cfgs/det_sample.yaml`` at full width over a synthetic KITTI val split
   of 4300 frustums (TEST.BATCH_SIZE 32, TPU.INFER_GROUP 2, weights from a
   ``.pth``); requires the native NMS and evaluator (``make -C native``) to
   have built, checks the result files, the detections, the evaluator's AP
   and that the main path launched the kernel; prints the frustums/s;
6. modes: the single-scale grouping (kernel 2) and the select alone
   (kernel 3) against their plain versions on the card, bit for bit
   (grouped, idx and cnt), at the flagship shapes (B=32, the profiler's
   batch, and B=256) and on every edge case of
   ``tests/test_select_pallas.py``, kernel 2 also against kernel 1 per
   scale, kernel 3 also on ``ops/grouping_cases.select_cases`` (NaN and
   +-inf, equal and ulp-apart depths, windows on bin edges, a clustered
   row); both timed with their plain versions at B=256 on scales 1
   (M=280, K=32) and 4 (M=35, K=128), and kernel 3 at B=32 on scale 1, in
   turns (plain, kernel, kernel, plain), each beside its bound and share;
7. profiler: ``frustum_convnet_tpu_torch.tools.profile_stages.main`` at
   batch 32, which must launch all three kernels; prints its stage lines;
8. train step: one step of the flagship model at batch 8 of the synthetic
   train split, on the card against the port on the CPU with the same
   seeded weights (TF32 off): the eight losses, and each parameter's
   gradient before the optimizer, also against the CPU in float64; and the
   train-mode pool's first-slot routing of tied slots on the card;
9. trainer: ``frustum_convnet_tpu_torch.engine.train.main`` on
   ``cfgs/det_sample.yaml`` at full width (TRAIN.BATCH_SIZE 32, 2 epochs of
   32 steps, disp 8, metrics sampled every disp steps) over a synthetic
   labeled split of 1024 train and 256 val frustums; checks finite losses,
   a kernel-1 launch on every train and eval step, the checkpoints (the
   final one reloads strictly into a fresh model with a bit-identical eval
   forward) and a resume at epoch 2; prints the steady train ms/step and
   frustums/s;
10. refine cascade (``scripts/car_all.sh`` after stage-1 training): a
    synthetic raw KITTI (``data/kitti/synthetic``, 384 frames of 4 cars),
    the port's ``data.kitti.prepare`` CLI (``--car_only --gen_train
    --gen_val --gen_val_rgb_detection``), stage-1 serving through
    ``engine.test.main`` with phase 9's ``model_final.pth``, the
    ``data.kitti.prepare_refine`` CLI on those result files, then
    ``cfgs/refine_car.yaml`` at full width (N=512, 64/32/16/8 sections whose
    tails repeat the last one) trained 2 epochs at batch 32 through
    ``engine.train.main`` and served through ``engine.test.main``; checks
    finite losses, a result file for every val id, the evaluator's AP and a
    kernel-1 launch on every forward; prints the refine train ms/step and
    the serving frustums/s;
11. SUN-RGBD: synthetic scenes (``data/sunrgbd/synthetic``, 384 frames of 4
    objects), the port's ``data.sunrgbd.prepare`` CLI (train, val and
    rgb-detection pickles), ``cfgs/det_sample_sunrgbd.yaml`` at full width
    (N=2048, 5 scales, K up to 256) trained 2 epochs at batch 32 and served
    through ``engine.test_sunrgbd.main`` ('top'); checks
    ``sunrgbd_ap.json`` and finite APs, one detection for each frustum
    that survives the degenerate-size filter, and the kernel-1 launches;
    prints the train ms/step and the serving frustums/s;
12. families: for refine car, refine people, people and SUN-RGBD, kernel 1
    bit for bit against its plain version on a B=32 batch of the family's
    provider (``ops/grouping_cases.family_datasets``), timed alone
    (``torch.profiler``) beside its bound and the plain version's time; bit
    for bit also at B=256 (the bench's per-config batch) on a provider
    batch and on the bench's fixture batch; and the family's forward at batch 8 on the card against the CPU (TF32 off,
    atol/rtol 1e-4);
13. precision and BatchNorm variants: the bfloat16 and float16 forward at
    batch 8 of phase 5's split, card against the CPU within the CPU's own
    distance from float32; one batch-8 train step each in bfloat16,
    float16, ghost BatchNorm (groups of 4), FAST_BN, FAST_BN_FIRST and
    REMAT_POINTNET, card against CPU; for float32, bfloat16 and float16 at
    batch 32, the step's time by CUDA events and its device time
    (``torch.profiler``), and the peak memory of a step with and without
    REMAT_POINTNET; ``engine.train.main`` at batch 32 in bfloat16 (2 epochs
    of 32 steps) and in float16 with TPU.F32_FINETUNE_EPOCHS 1 (3 epochs,
    the switch logged at epoch 2), printing each epoch's ms/step;
    ``engine.test.main`` at TPU.INFER_DTYPE bfloat16 on phase 5's split,
    its AP beside phase 5's; ``tools.profile_stages --dtype`` bfloat16 and
    float16, the forward ms beside phase 7's float32;
14. people cascade (``scripts/people_all.sh``): a synthetic KITTI of
    Pedestrians and Cyclists (384 frames of 4 objects), the port's
    ``data.kitti.prepare --people_only``, ``cfgs/det_sample_people.yaml``
    at full width (N=1024, 700/350/175/88 = 1313 sections) trained 2 epochs
    at batch 32 and served, ``data.kitti.prepare_refine --people_only`` on
    its result files, then ``cfgs/refine_people.yaml`` (N=512) trained 2
    epochs and served; checks finite losses, a result file for every val
    id, finite Pedestrian and Cyclist APs and a kernel-1 launch on every
    forward; prints each stage's train ms/step and frustums/s and serving
    frustums/s;
15. runners: ``tools.run_synth_protocol.main`` (``--frames 128 --epochs
    1``) and ``tools.run_refine_protocol.main`` on its output, each
    ``PROTOCOL_RESULT`` checked and printed, with a kernel-1 launch on
    every train, eval and serving forward;
16. data parallel (``parallel/mesh.py``): first one float32 train step at
    batch 32 and full width before the optimizer (``dp_step``, alone with
    ``--dp-gradients``), without a group twice, in a world-1 NCCL group and
    on two ranks sharing the card over gloo: the ranks' summed gradients
    bitwise equal, and losses within 1e-4 and every gradient leaf and
    running statistic within ``DP_GRAD_BOUND`` (relative L2) of one
    process; (a) world 1 over NCCL through the
    CLIs (``FRUSTUM_COORDINATOR`` etc. set for one process):
    ``engine.train.main`` as phase 9 runs it (its split, batch 32, 2 epochs),
    with finite losses, NCCL all-reduces on every step and kernel 1 on
    every forward, its ms/step printed beside phase 9's and its parameters' distance from phase 9's beside
    phase 9's distance from a second run of itself; ``engine.test.main`` on phase 5's split with
    those weights, and with phase 5's weights, whose result files must match
    phase 5's (``same_results``, the comparator of
    ``tests/test_torch_infer.py``) with equal AP; (b) two ranks sharing the
    card over gloo (``chip_smoke.py --rank``, ``rank_main``), trained 2 and
    8 steps at global batch 32 (16 a rank) on ``FixedDraws`` splits: the
    ranks' states bitwise equal, step-1 losses within 1e-4 of one process on
    the same global batches and the parameters within ``DP_BOUND`` a step
    (JAX's ``test_multihost.py`` bound over its 2 steps), only rank 0 wrote;
    phase 5's split served on both ranks in groups of one batch with the
    files and AP of one process serving it so (``TPU.INFER_GROUP 1``: a
    batch outside a group takes the full path, whose host-built ladders lie
    a rounding from the grouped path's); and
    NCCL refusing two ranks on the card on both ranks. Prints both ranks'
    ms/step and serving rates beside the card's name and power limit;
17. entry points (alone with ``--entry-points``, after phases 1 and 2):
    (a) ``graft_entry.entry()`` on the card against ``entry(device="cpu")``
    with the same seeded weights, every decoded output within atol/rtol
    1e-4 (TF32 off), one kernel-1 launch; (b)
    ``graft_entry.dryrun_multichip(2)``: 2 gloo ranks sharing the card (child
    processes), each level's train step audited (only all-reduces, the
    flat gradient buffer the one over twice the largest parameter), finite
    losses and inference, weak scaling within JAX's bound, kernel 1 on every
    forward of every rank; (c) ``ops/nms_device.rotate_nms_3d_device`` on
    the card: the host NMS's keep lists (``core/nms`` and the native
    ``ops/native``) on the seeded sets of
    ``tests/test_box_overlaps_nms_jax.py`` (n=24, max_out 16) and at n=256,
    max_out 64, no host sync in the greedy loop, and at n=256 its time by
    CUDA events beside the host NMS's; (d) ``tools.profile_train.main`` at
    batch 32 in float32 and bfloat16 (its rows, device-busy ms, kernels and
    peak memory a step), finite rows and kernel 1 on every timed call; (e)
    ``tools.profile_mlp.main`` at batch 256, its rows.
18. bench (alone with ``--bench``, after phases 1 and 2): the port's
    ``bench.main`` with ``--iters 3 --trials 1`` (every block of the
    repository bench at full width: inference at B=32/256/1024, serving,
    the float32 train sweep at 32/128/256, the supported recipes, the three
    secondary configs and the refine train step), then
    ``tools.bench_models`` on ``refine_people`` at batch 32 and
    ``tools.bench_driver`` on a 64-frame synthetic split (batch 4, group 8,
    2 in flight: two full groups). Every block's rate, TFLOP/s and MFU and
    every number of the bench's last line must be finite and positive,
    nothing skipped, and kernel 1 must launch in every block, the config
    row and the driver line; prints each tool's seconds.

The splits of phases 4-9 are written here from seeded numpy, with one car
generator: the val split in the reference's 7-stream rgb-detection pickle
layout (id, box2d, points, type, frustum_angle, prob, calib), with KITTI
``label_2`` ground truth and ``image_sets/val.txt``; the train and labeled
val splits in the 11-stream labeled layout (id, box2d, box3d, points, seg,
type, heading, size, frustum_angle, gt_box2d, calib). The drivers read them
like any other split. Phases 10-12 write raw synthetic KITTI and SUN-RGBD
with the port's generators and run the port's prep on them.

Each kernel's ``launches`` in the kernels record is counted over one main
path, with the counts set to 0 just before it: kernel 1 over the trainer's
run (phase 9), kernels 2 and 3 over the profiler's (phase 7).
``path_launches`` gives each kernel's launches on every driver path, each
counted the same way: serving and training (phases 5 and 9), the refine
cascade's stage-1 serving, training and serving (phase 10), and SUN-RGBD
training and serving (phase 11), bfloat16 training, float16 training with
the float32 fine-tune and bfloat16 serving (phase 13), the people cascade's
stage-1 and refine training and serving (phase 14), each protocol
runner (phase 15), world-1 training and both world-1 servings and the
2-rank training (8 steps) and serving, both ranks' launches (phase 16),
``entry()``, every rank of the dry-run and both ``profile_train``
runs (phase 17), and the bench, ``bench_models`` and ``bench_driver``
(phase 18); only kernel 1 runs there.
``main_path_launches`` is their sum. Kernel 1's ``family_shapes`` holds its
phase-12 numbers. Launches that compare a kernel with its plain version are
not counted. ``bound_ms`` is
the least time the card could take for the timed call (its bytes over the
HBM rate or its float32 operations over the float32 instruction rate,
whichever is larger); ``library_ms`` is null: no single PyTorch call computes this select.
The run fails if any module of the JAX package (or jax) was imported.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SMOKE_SEED = 3
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)

# KITTI's P2 (left color camera) and image size; rect camera frame is
# x right, y down, z forward, with the road 1.65 m below the camera.
KITTI_P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                     [0.0, 721.5377, 172.854, 0.2163791],
                     [0.0, 0.0, 1.0, 0.002745884]])
IMG_W, IMG_H = 1242, 375
CAR_LWH, CAR_LWH_SIGMA = (3.9, 1.6, 1.5), (0.2, 0.1, 0.1)
RGB_DET_FIELDS = ("id", "box2d", "points", "type", "frustum_angle", "prob",
                  "calib")
LABELED_FIELDS = ("id", "box2d", "box3d", "points", "seg", "type", "heading",
                  "size", "frustum_angle", "gt_box2d", "calib")
# KITTI's 8-corner order (bottom face first, y down): signs of l/2, h/2, w/2
CORNER_SIGNS = np.array([[1, 1, -1, -1, 1, 1, -1, -1],
                         [1, 1, 1, 1, -1, -1, -1, -1],
                         [1, -1, -1, 1, 1, -1, -1, 1]], np.float64).T


def _in_turns(kernel, plain, kernel_iters: int = 50, plain_iters: int = 10):
    """(kernel ms, plain ms): timed plain, kernel, kernel, plain."""
    from frustum_convnet_tpu_torch.tools.time_grouping import cuda_time_ms

    p1 = cuda_time_ms(plain, plain_iters)
    k1 = cuda_time_ms(kernel, kernel_iters)
    k2 = cuda_time_ms(kernel, kernel_iters)
    p2 = cuda_time_ms(plain, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


def flagship_cfg(data_root: str | None = None, cfg_file: str = "det_sample.yaml"):
    """``cfgs/<cfg_file>`` (the flagship's by default), reading ``data_root``."""
    from frustum_convnet_tpu_torch import configs

    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(os.path.join(ROOT, "cfgs", cfg_file), cfg)
    if data_root:
        configs.merge_cfg_from_list(["DATA.DATA_ROOT", data_root], cfg)
    return cfg


def phase_kernel(spec, device) -> dict:
    """Kernel vs plain version, bit for bit, on the edge cases and at the
    flagship B=32, 64, 256 and 1024 (the tile count a row gets depends on
    the batch; 1024 is the bench's largest inference batch, B*M*K =
    1024*280*32 on scale 1); timed at those batches beside its bound, and
    against the plain version at B=256."""
    from frustum_convnet_tpu_torch.ops import grouping_cases, select_cuda
    from frustum_convnet_tpu_torch.ops.query_depth_point import group_depth_point_multi
    from frustum_convnet_tpu_torch.tools.time_grouping import cuda_time_ms, kernel_bound

    cases = dict(grouping_cases.edge_cases())
    batches = (32, 64, 256, 1024)
    for batch in batches:
        cases[f"flagship_b{batch}"] = grouping_cases.flagship_case(spec, batch=batch)
    max_err = 0.0
    for name, (pts, refs, dzs, ks) in cases.items():
        t_pts = torch.from_numpy(pts).to(device)
        t_refs = [torch.from_numpy(r).to(device) for r in refs]
        got = select_cuda.group_depth_point_multi_cuda(t_pts, t_refs, dzs, ks)
        want = group_depth_point_multi(t_pts, t_refs, dzs, ks)
        torch.cuda.synchronize()
        for (g, c), (g0, c0) in zip(got, want):
            if g.shape != g0.shape or not torch.equal(c, c0) or not torch.equal(g, g0):
                raise AssertionError(f"kernel != plain version on case {name}")
            max_err = max(max_err, (g - g0).abs().max().item())
    print(f"[kernel] bit-identical to the plain version on {len(cases)} cases "
          f"(flagship B={', '.join(map(str, batches))} and "
          f"{len(cases) - len(batches)} edge cases)")

    for batch in batches:
        pts, refs, dzs, ks = cases[f"flagship_b{batch}"]
        t_pts = torch.from_numpy(pts).to(device)
        t_refs = [torch.from_numpy(r).to(device) for r in refs]
        kernel = lambda: select_cuda.group_depth_point_multi_cuda(t_pts, t_refs, dzs, ks)
        bound = kernel_bound("group_depth_point_multi", t_pts, t_refs, dzs, ks)
        if batch == 256:
            ms, plain_ms, (k1, k2, p1, p2) = _in_turns(
                kernel, lambda: group_depth_point_multi(t_pts, t_refs, dzs, ks))
            timed = (f"kernel {ms:.4f} ms ({k1:.4f}, {k2:.4f}), plain "
                     f"{plain_ms:.4f} ms ({p1:.4f}, {p2:.4f})")
            record = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
        else:
            ms = cuda_time_ms(kernel, 200)
            timed = f"kernel {ms:.4f} ms"
        print(f"[kernel] flagship B={batch}: {timed}; bound {bound['bound_ms']:.4f} "
              f"ms ({bound['bound_by']}: {bound['bytes'] / 1e6:.2f} MB, "
              f"{bound['operations'] / 1e6:.1f} M float32 ops), share "
              f"{bound['bound_ms'] / ms:.1%}")
    return record


def phase_modes(spec, device) -> dict:
    """Kernels 2 (one scale) and 3 (select only) against their plain
    versions, bit for bit, and kernel 2 against kernel 1 per scale, on the
    edge cases and at the flagship B=32 and 256; timed at
    B=256 on scales 1 and 4. Returns their kernels-record numbers (times of
    scale 1, M=280, K=32)."""
    from frustum_convnet_tpu_torch.ops import grouping_cases, select_cuda
    from frustum_convnet_tpu_torch.ops import query_depth_point as qdp
    from frustum_convnet_tpu_torch.tools.time_grouping import kernel_bound

    cases = dict(grouping_cases.edge_cases())
    for batch in (32, 256):  # the profiler's batch, and the timed one
        cases[f"flagship_b{batch}"] = grouping_cases.flagship_case(spec, batch=batch)
    err = {"group_depth_point": 0.0, "query_depth_point": 0.0}
    for name, (pts, refs, dzs, ks) in cases.items():
        t_pts = torch.from_numpy(pts).to(device)
        z_points = t_pts[..., 2].contiguous()
        multi = select_cuda.group_depth_point_multi_cuda(
            t_pts, [torch.from_numpy(r).to(device) for r in refs], dzs, ks)
        for ref, d, k, (gm, cm) in zip(refs, dzs, ks, multi):
            t_ref = torch.from_numpy(ref).to(device)
            z_ref = t_ref[..., 2].contiguous()
            g, c = select_cuda.group_depth_point_cuda(t_pts, t_ref, d, k)
            g0, c0 = qdp.group_depth_point(t_pts, t_ref, d, k)
            idx, cnt = select_cuda.query_depth_point_cuda(z_points, z_ref, d, k)
            idx0, cnt0 = qdp.query_depth_point(z_points, z_ref, d, k)
            torch.cuda.synchronize()
            if not (g.shape == g0.shape and torch.equal(g, g0) and torch.equal(c, c0)):
                raise AssertionError(f"kernel 2 != plain version on case {name}")
            if not (torch.equal(g, gm) and torch.equal(c, cm)):
                raise AssertionError(f"kernel 2 != kernel 1 on case {name}")
            if not (idx.shape == idx0.shape and torch.equal(idx, idx0)
                    and torch.equal(cnt, cnt0)):
                raise AssertionError(f"kernel 3 != plain version on case {name}")
            err["group_depth_point"] = max(err["group_depth_point"],
                                           (g - g0).abs().max().item())
            err["query_depth_point"] = max(err["query_depth_point"],
                                           (idx - idx0).abs().max().item())
    select = grouping_cases.select_cases()
    for name, (zp, zr, d, k) in select.items():
        z_points, z_ref = (torch.from_numpy(a).to(device) for a in (zp, zr))
        idx, cnt = select_cuda.query_depth_point_cuda(z_points, z_ref, d, k)
        idx0, cnt0 = qdp.query_depth_point(z_points, z_ref, d, k)
        torch.cuda.synchronize()
        if not (idx.shape == idx0.shape and torch.equal(idx, idx0)
                and torch.equal(cnt, cnt0)):
            raise AssertionError(f"kernel 3 != plain version on select case {name}")
    print(f"[modes] kernels 2 and 3 bit-identical to their plain versions (and "
          f"kernel 2 to kernel 1) on {len(cases)} cases (flagship B=32, 256 and "
          f"{len(cases) - 2} edge cases); kernel 3 also on {len(select)} select "
          f"cases (non-finite, equal and ulp-apart depths, bin edges, clustered)")

    out = {}
    for batch, i, names in ((256, 0, ("group_depth_point", "query_depth_point")),
                            (256, 3, ("group_depth_point", "query_depth_point")),
                            (32, 0, ("query_depth_point",))):
        pts, refs, dzs, ks = cases[f"flagship_b{batch}"]
        t_pts = torch.from_numpy(pts).to(device)
        z_points = t_pts[..., 2].contiguous()
        t_ref = torch.from_numpy(refs[i]).to(device)
        z_ref = t_ref[..., 2].contiguous()
        m, d, k = t_ref.shape[1], dzs[i], ks[i]
        calls = {"group_depth_point":
                 (lambda: select_cuda.group_depth_point_cuda(t_pts, t_ref, d, k),
                  lambda: qdp.group_depth_point(t_pts, t_ref, d, k), batch * m * k * 3 * 4),
                 "query_depth_point":
                 (lambda: select_cuda.query_depth_point_cuda(z_points, z_ref, d, k),
                  lambda: qdp.query_depth_point(z_points, z_ref, d, k), batch * m * k * 4)}
        for name in names:
            kernel, plain, out_bytes = calls[name]
            ms, plain_ms, (k1, k2, p1, p2) = _in_turns(kernel, plain)
            bound = kernel_bound(name, t_pts, [t_ref], [d], [k])
            print(f"[modes] {name} scale {i + 1} (M={m}, K={k}) B={batch}: kernel "
                  f"{ms:.4f} ms ({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms "
                  f"({p1:.4f}, {p2:.4f}); output {out_bytes / 1e6:.2f} MB -> "
                  f"{out_bytes / ms / 1e6:.1f} GB/s; bound {bound['bound_ms']:.4f} "
                  f"ms ({bound['bound_by']}; 2 operations a selected hit), share "
                  f"{bound['bound_ms'] / ms:.1%}")
            if (batch, i) == (256, 0):
                out[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
    return out


def _counters():
    from frustum_convnet_tpu_torch.ops import select_cuda

    return {"group_depth_point_multi": select_cuda.group_depth_point_multi_cuda,
            "group_depth_point": select_cuda.group_depth_point_cuda,
            "query_depth_point": select_cuda.query_depth_point_cuda}


def _reset_counts() -> None:
    for c in _counters().values():
        c.launches = 0


def _counts() -> dict:
    return {name: c.launches for name, c in _counters().items()}


def phase_profiler() -> tuple:
    """The stage profiler at batch 32; returns each kernel's launches in it
    and its stage times."""
    from frustum_convnet_tpu_torch.tools import profile_stages

    _reset_counts()
    times = profile_stages.main(["--batch", "32"])
    launches = _counts()
    if min(launches.values()) <= 0:
        raise AssertionError(f"the profiler did not launch every kernel: {launches}")
    print(f"[profiler] kernel launches: {launches}")
    return launches, times


def _roty(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _to_image(pts: np.ndarray) -> np.ndarray:
    """Rect-camera points (n, 3) -> pixels (n, 2) through P2."""
    uvw = np.hstack([pts, np.ones((len(pts), 1))]) @ KITTI_P2.T
    return uvw[:, :2] / uvw[:, 2:]


def _to_rect(u, v, z) -> np.ndarray:
    """Pixels at rect depths -> rect-camera points (n, 3), KITTI's
    back-projection (the provider's ``project_image_to_rect``)."""
    p = KITTI_P2
    x = (u - p[0, 2]) * z / p[0, 0] + p[0, 3] / -p[0, 0]
    y = (v - p[1, 2]) * z / p[1, 1] + p[1, 3] / -p[1, 1]
    return np.stack(np.broadcast_arrays(x, y, z), axis=-1)


def label_rule(ladder, center, lhw, rot) -> np.ndarray:
    """The stage-1 training label rule (``data/provider.section_labels``):
    a section is foreground when its center lies in the half-size box
    (``lhw`` along the box's x, y, z); the nearest section when none does."""
    inside = (np.abs((ladder - center) @ rot) <= np.asarray(lhw) / 4).all(axis=1)
    if not inside.any():
        inside[np.argmin(np.linalg.norm(ladder - center, axis=1))] = True
    return inside


def _section_depths(spec) -> np.ndarray:
    """Depths of the output (scale-2) sections."""
    return np.arange(0, spec.max_depth, spec.strides[1]) + spec.strides[1] / 2


def synthetic_car(rng, spec) -> dict:
    """One car 5-40 m away (at least 27 px tall) and its frustum: LiDAR
    returns on the car falling off with range and background returns through
    the whole frustum, the 2D box jittered 5% as a detector's is.

    Returns the KITTI label line, box2d (jittered) and gt_box2d, the points
    (n, 4) float32 with intensity, seg (n,) (1 on the car), the 3D box
    (center, (l, w, h), ry, corners (8, 3) in KITTI order), frustum_angle,
    a detector prob, and ``fg``: the output sections ``label_rule`` marks
    foreground on the ladder through the 2D box center."""
    depth = rng.uniform(5.0, 40.0)
    lateral = rng.uniform(-0.2, 0.2) * depth
    l, w, h = (m + rng.normal(0, s) for m, s in zip(CAR_LWH, CAR_LWH_SIGMA))
    ry = rng.uniform(-np.pi, np.pi)
    rot = _roty(ry)
    center = np.array([lateral, 1.65 - h / 2, depth])
    box_signs = np.array([[sx, sy, sz] for sx in (-.5, .5) for sy in (-.5, .5)
                          for sz in (-.5, .5)])
    uv = _to_image(box_signs * [l, h, w] @ rot.T + center)
    (fx1, fy1), (fx2, fy2) = uv.min(0), uv.max(0)
    x1, x2 = np.clip([fx1, fx2], 0, IMG_W - 1)
    y1, y2 = np.clip([fy1, fy2], 0, IMG_H - 1)
    trunc = 1.0 - (x2 - x1) * (y2 - y1) / ((fx2 - fx1) * (fy2 - fy1))
    alpha = (ry - np.arctan2(lateral, depth) + np.pi) % (2 * np.pi) - np.pi
    label = (f"Car {trunc:.2f} 0 {alpha:.2f} {x1:.2f} {y1:.2f} "
             f"{x2:.2f} {y2:.2f} {h:.2f} {w:.2f} {l:.2f} "
             f"{lateral:.2f} {1.65:.2f} {depth:.2f} {ry:.2f}")
    jw, jh = 0.05 * (x2 - x1), 0.05 * (y2 - y1)
    box2d = np.array([max(0.0, x1 + rng.uniform(-jw, jw)),
                      max(0.0, y1 + rng.uniform(-jh, jh)),
                      min(IMG_W - 1.0, x2 + rng.uniform(-jw, jw)),
                      min(IMG_H - 1.0, y2 + rng.uniform(-jh, jh))])

    n_car = int(np.clip(15000 / depth, 40, 2000))
    car = rng.uniform(-0.5, 0.5, (n_car, 3)) * [l, h, w] @ rot.T + center
    n_bg = 1200
    bg = _to_rect(rng.uniform(box2d[0], box2d[2], n_bg),
                  rng.uniform(box2d[1], box2d[3], n_bg),
                  rng.uniform(2.0, spec.max_depth, n_bg))
    pts = np.concatenate([car, bg])
    uv = _to_image(pts)
    keep = ((uv[:, 0] >= box2d[0]) & (uv[:, 0] < box2d[2])
            & (uv[:, 1] >= box2d[1]) & (uv[:, 1] < box2d[3]))
    pts = np.hstack([pts[keep], rng.uniform(0, 1, (keep.sum(), 1))])
    seg = (np.arange(n_car + n_bg) < n_car)[keep].astype(np.int64)

    cu, cv = (box2d[0] + box2d[2]) / 2, (box2d[1] + box2d[3]) / 2
    ray = _to_rect(cu, cv, 20.0)
    fg = label_rule(_to_rect(cu, cv, _section_depths(spec)), center, (l, h, w), rot)
    return {"label": label, "box2d": box2d,
            "gt_box2d": np.array([x1, y1, x2, y2]),
            "points": pts.astype(np.float32), "seg": seg, "center": center,
            "size": np.array([l, w, h]), "ry": ry,
            "corners": CORNER_SIGNS * [l / 2, h / 2, w / 2] @ rot.T + center,
            "frustum_angle": float(-np.arctan2(ray[2], ray[0])),
            "prob": float(rng.uniform(0.7, 0.99)), "fg": fg}


def make_val_split(work: str, spec, num_frames: int = 1075,
                   cars_per_frame: int = 4, seed: int = 1) -> dict:
    """Synthetic KITTI val split: ``num_frames`` frames of ``cars_per_frame``
    cars (``synthetic_car``). 1075 frames give 4300 frustums: 67 groups of
    two 32-frustum batches and a padded tail batch, so the steady-state
    window spans 66 groups.

    Also returns ``fg_labels`` (frustums, L) bool: the output sections that
    ``label_rule`` marks foreground on the ladder through each 2D box
    center, which is what a trained stage-1 head scores foreground."""
    rng = np.random.default_rng(seed)
    kitti_root = os.path.join(work, "kitti")
    label_dir = os.path.join(kitti_root, "training", "label_2")
    pickle_dir = os.path.join(work, "pickles")
    for d in (label_dir, pickle_dir, os.path.join(kitti_root, "image_sets")):
        os.makedirs(d)
    streams = {k: [] for k in RGB_DET_FIELDS}
    labels_fg = []
    for frame in range(num_frames):
        labels = []
        for _ in range(cars_per_frame):
            car = synthetic_car(rng, spec)
            labels.append(car["label"])
            labels_fg.append(car["fg"])
            streams["id"].append(frame)
            streams["type"].append("Car")
            streams["calib"].append({"P2": KITTI_P2.copy()})
            for k in ("box2d", "points", "frustum_angle", "prob"):
                streams[k].append(car[k])
        with open(os.path.join(label_dir, f"{frame:06d}.txt"), "w") as f:
            f.write("\n".join(labels) + "\n")

    with open(os.path.join(pickle_dir, "frustum_caronly_val_rgb_detection.pickle"),
              "wb") as f:
        for k in RGB_DET_FIELDS:  # one pickle stream per field, in order
            pickle.dump(streams[k], f, protocol=pickle.HIGHEST_PROTOCOL)
    idx_path = os.path.join(kitti_root, "image_sets", "val.txt")
    with open(idx_path, "w") as f:
        f.write("\n".join(f"{i:06d}" for i in range(num_frames)) + "\n")
    return {"pickle_dir": pickle_dir, "gt_dir": label_dir, "idx_path": idx_path,
            "fg_labels": np.stack(labels_fg)}


def make_train_split(pickle_dir: str, spec, num_train: int = 1024,
                     num_val: int = 256, seed: int = 2) -> None:
    """Labeled synthetic KITTI splits for training, one car a frustum
    (``synthetic_car``): ``frustum_caronly_{train,val}.pickle`` in
    ``pickle_dir``, in the 11-stream labeled layout that the stage-1
    provider reads."""
    rng = np.random.default_rng(seed)
    os.makedirs(pickle_dir, exist_ok=True)
    for split, n in (("train", num_train), ("val", num_val)):
        streams = {k: [] for k in LABELED_FIELDS}
        for i in range(n):
            car = synthetic_car(rng, spec)
            streams["id"].append(i)
            streams["box3d"].append(car["corners"])
            streams["type"].append("Car")
            streams["heading"].append(car["ry"])
            streams["calib"].append({"P2": KITTI_P2.copy()})
            for k in ("box2d", "points", "seg", "size", "frustum_angle", "gt_box2d"):
                streams[k].append(car[k])
        with open(os.path.join(pickle_dir, f"frustum_caronly_{split}.pickle"), "wb") as f:
            for k in LABELED_FIELDS:
                pickle.dump(streams[k], f, protocol=pickle.HIGHEST_PROTOCOL)


def split_batch(dataset, indices, num_scales: int):
    """Model inputs (points, one_hot, refs) of the split's frustums at
    ``indices``, as the driver's provider prepares them."""
    rng = np.random.default_rng(SMOKE_SEED)
    items = [dataset.__getitem__(i, rng) for i in indices]
    return (torch.from_numpy(np.stack([it["point_cloud"] for it in items])),
            torch.from_numpy(np.stack([it["one_hot"] for it in items])),
            [torch.from_numpy(np.stack([it["refs"][s] for it in items]))
             for s in range(num_scales)])


def seeded_model(spec):
    """The port's seeded init with BatchNorm running stats moved off
    identity (so the normalization is exercised)."""
    from frustum_convnet_tpu_torch.models.net import FrustumConvNet

    gen = torch.Generator().manual_seed(SMOKE_SEED)
    model = FrustumConvNet(spec)
    model.reset_parameters(gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                mod.running_mean.normal_(0.0, 0.1, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
    return model.eval()


def fit_cls_head(spec, model, dataset, fg_labels: np.ndarray, device,
                 n: int = 256) -> None:
    """Fit the cls head to the label-rule foreground of the split's first
    ``n`` frustums, in place of a trained stage-1 head. The seeded head
    scores all of a frustum's sections foreground or none of them, so the
    driver's compaction and host NMS would see traffic no trained model
    sends. The fit is ridge least squares on the seeded trunk's section
    features (frozen), positives weighted up to balance the negatives, with the
    threshold set so that the fitted frustums score as many sections
    foreground as their labels hold."""
    head = model.cls_out
    c = head.in_channels
    probe = torch.nn.Conv1d(c, c, 1)  # identity head: the logits are the features
    with torch.no_grad():
        probe.weight.copy_(torch.eye(c)[:, :, None])
        probe.bias.zero_()
        model.cls_out = probe
        model.to(device)
        feats = []
        for lo in range(0, n, 64):
            pts, one_hot, refs = split_batch(dataset, range(lo, lo + 64), spec.num_scales)
            feats.append(model(pts.to(device), one_hot.to(device),
                               [r.to(device) for r in refs])[0])
        model.cls_out = head
        model.cpu()
        x = torch.cat(feats).double().flatten(0, 1)  # (n * L, C)
        x = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
        y = torch.from_numpy(fg_labels[:n]).to(device).flatten()
        sw = torch.where(y, (~y).sum() / y.sum(), 1.0).double()[:, None]
        gram = (x * sw).T @ x + torch.eye(c + 1, dtype=x.dtype, device=device)
        w = torch.linalg.solve(gram, (x * sw).T @ (2.0 * y.double() - 1.0))
        margin = x @ w
        threshold = torch.sort(margin, descending=True).values[int(y.sum())]
        w[c] -= threshold
        fg = (margin > threshold).view(n, -1).cpu()
        # the fitted margin becomes logit_fg - logit_bg
        head.weight[:, :, 0] = (torch.stack([-w[:c], w[:c]]) / 2).float().cpu()
        head.bias.copy_((torch.stack([-w[c], w[c]]) / 2).float().cpu())
    labels = torch.from_numpy(fg_labels[:n])
    count = fg.sum(dim=1)
    print(f"[data] cls head fitted on {n} frustums: {count.float().mean().item():.3f} "
          f"foreground sections a frustum (labels "
          f"{labels.sum(dim=1).float().mean().item():.3f}), median "
          f"{count.median().item()}, max {count.max().item()}, "
          f"{(count == 0).float().mean().item():.1%} with none (argmax fallback), "
          f"{(count > 64).sum().item()} over the 64 cap; recall "
          f"{(fg & labels).sum().item() / labels.sum().item():.3f}")


def phase_model(spec, device, model, dataset, tag: str = "model") -> None:
    """Forward at batch 8 of ``dataset``: card against the port on the CPU."""
    inputs = split_batch(dataset, range(8), spec.num_scales)
    with torch.no_grad():
        cpu = model(*inputs)
        model.to(device)
        gpu = model(inputs[0].to(device), inputs[1].to(device),
                    [r.to(device) for r in inputs[2]])
        model.cpu()
    for name, c, g in zip(("cls_logits", "reg"), cpu, gpu):
        g = g.cpu()
        if c.shape != g.shape or not torch.isfinite(g).all():
            raise AssertionError(f"[{tag}] {name}: shape {tuple(g.shape)} or non-finite")
        torch.testing.assert_close(g, c, **MODEL_TOL)
        print(f"[{tag}] {name} {tuple(g.shape)}: card vs CPU max abs diff "
              f"{(g - c).abs().max().item():.3e} (atol/rtol 1e-4)")


def phase_driver(model, split: dict, work: str, opts=(), tag: str = "driver",
                 weights_name: str = "smoke_init.pth") -> dict:
    """The port's CLI entry point on the card over ``split`` (with the
    config overrides ``opts``), ``model`` saved as ``weights_name``; returns
    each kernel's launches in that run, the evaluator's car APs, the result
    directory and the frustum count."""
    import math

    from frustum_convnet_tpu_torch.engine import checkpoints
    from frustum_convnet_tpu_torch.engine import test as driver
    from frustum_convnet_tpu_torch.ops import native

    weights = os.path.join(work, weights_name)
    checkpoints.save_checkpoint(weights, model)
    if not native.native_available():
        raise AssertionError("the native NMS and evaluator did not build "
                             "(make -C native): the driver would run numpy")

    _reset_counts()
    out = driver.main([
        "--cfg", os.path.join(ROOT, "cfgs", "det_sample.yaml"),
        "--device", "cuda", "--gt_dir", split["gt_dir"],
        "--idx_path", split["idx_path"],
        "DATA.DATA_ROOT", split["pickle_dir"],
        "OUTPUT_DIR", os.path.join(work, "output_" + tag.replace(" ", "_")),
        "TEST.BATCH_SIZE", "32", "TPU.INFER_GROUP", "2",
        "TEST.WEIGHTS", weights, *opts])
    counts = _counts()
    launches = counts["group_depth_point_multi"]

    stats = out["stats"]
    n_batches = math.ceil(stats["frustums"] / 32)
    if not (stats["frustums"] >= 100 and n_batches % 2 == 1
            and stats["frustums"] % 32):
        raise AssertionError(f"split of {stats['frustums']} frustums does not "
                             "give grouped dispatches plus a padded tail batch")
    with open(split["idx_path"]) as f:
        n_ids = sum(1 for line in f if line.strip())
    files = sorted(os.listdir(out["result_dir"]))
    if len(files) != n_ids:
        raise AssertionError(f"{len(files)} result files for {n_ids} split ids")
    values = []
    for name in files:
        with open(os.path.join(out["result_dir"], name)) as f:
            values += [[float(v) for v in line.split()[3:]] for line in f if line.strip()]
    if not values or not np.isfinite(np.asarray(values)).all():
        raise AssertionError("no detections written, or non-finite values")
    if stats["detections"] <= 0:
        raise AssertionError("the driver made no detections")
    ap = out["ap"]
    if not ap or "car" not in ap or "detection_3d" not in ap["car"]:
        raise AssertionError(f"the evaluator returned {ap!r}")
    if launches <= 0:
        raise AssertionError("the driver's run never launched the CUDA kernel")
    expected = n_batches // 2 + 1 + stats["overflow_reruns"]
    print(f"[{tag}] {stats['frustums']} frustums, {n_batches} batches of 32 in "
          f"groups of 2: {launches} kernel launches (expected {expected}), "
          f"{stats['sections']} foreground sections "
          f"({stats['sections'] / stats['frustums']:.3f} a frustum), "
          f"{stats['detections']} detections "
          f"({stats['detections'] / stats['frustums']:.3f} a frustum), "
          f"{len(values)} after NMS in {len(files)} files, "
          f"{stats['overflow_reruns']} overflow re-runs")
    print(f"[{tag}] end-to-end {stats['frustums_per_s']:.1f} frustums/s over "
          f"{stats['seconds']:.2f}s; steady-state "
          f"{stats['steady_frustums_per_s']:.1f} frustums/s")
    print(f"[{tag}] car AP 2D/BEV/3D (easy, moderate, hard): "
          f"{ap['car']['detection']} {ap['car']['detection_ground']} "
          f"{ap['car']['detection_3d']}")
    return {"counts": counts, "ap": ap["car"], "result_dir": out["result_dir"],
            "frustums": stats["frustums"]}


def labeled_batch(dataset, indices, num_scales: int) -> dict:
    """A collated labeled numpy batch of the split's frustums at ``indices``
    (the train step's keys), as the trainer's loader prepares it."""
    rng = np.random.default_rng(SMOKE_SEED)
    items = [dataset.__getitem__(i, rng) for i in indices]
    batch = {k: np.stack([it[k] for it in items])
             for k in ("point_cloud", "one_hot", "cls_label", "box3d_center",
                       "box3d_heading", "box3d_size", "size_class")}
    batch["refs"] = tuple(np.stack([it["refs"][s] for it in items])
                          for s in range(num_scales))
    return batch


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


def phase_train_step(spec, device, model, dataset) -> None:
    """One train step at batch 8: card against the CPU, before the optimizer.

    Tolerances, for float32 with TF32 off: losses rtol 1e-4; each gradient
    leaf within 5e-3 of the CPU's float32 gradient and of its float64 one, in
    relative L2 norm. Exact agreement is not expected: the card sums in
    another order than the CPU (cuDNN's convolution backward may sum with
    atomics, in an order that changes from run to run), and the BatchNorm
    bias and scale gradients are sums that cancel. Measured on an H100: the
    card's worst leaf 1.6e-3 from float64 (a trunk BatchNorm bias), the
    CPU's 5.2e-4. Parameters
    after Adam are not compared: its first step is close to lr*sign(g), so a
    near-zero gradient whose sign flips moves a parameter by up to 2*lr."""
    import copy

    from frustum_convnet_tpu_torch.models.net import slot_max_pool
    from frustum_convnet_tpu_torch.ops import query_depth_point as qdp
    from frustum_convnet_tpu_torch.parallel import train_step as ts

    # the train-mode pool on the card: tied slots (first-hit fill) route the
    # gradient to the first of them, as on the CPU
    rng = np.random.default_rng(SMOKE_SEED)
    x = rng.integers(0, 3, (8, 35, 128, 16)).astype(np.float32)
    x[:, :, 40:] = x[:, :, :1]
    cot = torch.from_numpy(rng.normal(size=(8, 35, 16)).astype(np.float32))
    grads = []
    for dev in ("cpu", device):
        t = torch.from_numpy(x).to(dev).requires_grad_()
        (slot_max_pool(t, train=True) * cot.to(dev)).sum().backward()
        grads.append(t.grad.cpu())
    if not (torch.equal(grads[0], grads[1])
            and ((grads[1] != 0).sum(dim=2) <= 1).all()):
        raise AssertionError("the train-mode pool routes tied slots differently "
                             "on the card")

    batch = labeled_batch(dataset, range(8), spec.num_scales)
    groups = qdp.group_depth_point_multi(
        torch.from_numpy(batch["point_cloud"]),
        [torch.from_numpy(r) for r in batch["refs"]], spec.height_half, spec.nsamples)
    partial = sum(int(((c > 0) & (c < k)).sum()) for (_, c), k in zip(groups, spec.nsamples))
    if partial == 0:
        raise AssertionError("the batch has no section with 0 < cnt < K")

    cfg = ts.TrainStepConfig(compute_metrics=False)
    runs = {}
    for tag, dev, dtype in (("cpu", "cpu", torch.float32),
                            ("cpu64", "cpu", torch.float64),
                            ("card", device, torch.float32)):
        m = copy.deepcopy(model).to(dev, dtype)
        losses, _ = ts.loss_and_grads(m, spec, cfg, ts.to_device(batch, dev, dtype))
        runs[tag] = ({k: v.item() for k, v in losses.items()},
                     {n: p.grad.detach().cpu().double() for n, p in m.named_parameters()})
    (l_cpu, g_cpu), (l_64, g_64), (l_card, g_card) = (runs[k] for k in ("cpu", "cpu64", "card"))
    for k, v in l_card.items():
        if not np.isfinite(v) or abs(v - l_cpu[k]) > 1e-4 * abs(l_cpu[k]) + 1e-6:
            raise AssertionError(f"{k}: card {v} vs CPU {l_cpu[k]}")
    worst_cpu = max((_rel(g_card[n], g_cpu[n]), n) for n in g_card)
    worst_64 = max((_rel(g_card[n], g_64[n]), n) for n in g_card)
    worst_cpu64 = max((_rel(g_cpu[n], g_64[n]), n) for n in g_card)
    if worst_cpu[0] > 5e-3 or worst_64[0] > 5e-3:
        raise AssertionError(f"card gradients off: vs CPU {worst_cpu}, vs CPU "
                             f"float64 {worst_64}")
    print(f"[train step] batch 8, {partial} sections with 0 < cnt < K; losses "
          f"card vs CPU max rel diff "
          f"{max(abs(l_card[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu):.3e} "
          f"(total {l_card['total_loss']:.6f}, CPU {l_cpu['total_loss']:.6f})")
    print(f"[train step] {len(g_card)} gradient leaves, worst relative L2: card vs "
          f"CPU {worst_cpu[0]:.3e} ({worst_cpu[1]}), card vs CPU float64 "
          f"{worst_64[0]:.3e} ({worst_64[1]}), CPU vs CPU float64 "
          f"{worst_cpu64[0]:.3e} (bound 5e-3)")


def _logged_losses(log_path: str) -> list:
    """Every number on the trainer's disp-interval lines."""
    values = []
    with open(log_path) as f:
        for line in f:
            if " it " in line and "total_loss" in line:
                words = line.split("total_loss", 1)[1].split()
                values += [float(w) for w in words[::2]]
    return values


def phase_trainer(spec, device, work: str, pickle_dir: str) -> dict:
    """The port's training CLI entry point on the card; returns its kernel-1
    launches and the steady epoch's stats."""
    import math

    from frustum_convnet_tpu_torch.engine import checkpoints
    from frustum_convnet_tpu_torch.engine import train as trainer
    from frustum_convnet_tpu_torch.models.net import FrustumConvNet

    out_dir = os.path.join(work, "train_output")
    args = ["--cfg", os.path.join(ROOT, "cfgs", "det_sample.yaml"),
            "--device", "cuda", "DATA.DATA_ROOT", pickle_dir,
            "OUTPUT_DIR", out_dir, "TRAIN.BATCH_SIZE", "32",
            "TEST.BATCH_SIZE", "32", "disp", "8", "TPU.METRIC_INTERVAL", "-1",
            "USE_TFBOARD", "False"]
    _reset_counts()
    res = trainer.main(args + ["TRAIN.MAX_EPOCH", "2"])
    counts = _counts()
    launches = counts["group_depth_point_multi"]

    cfg = flagship_cfg(pickle_dir)
    _, val_ds = trainer.make_datasets(cfg)
    steps = sum(e["steps"] for e in res["epochs"])
    evals = 2 * math.ceil(len(val_ds) / 32)
    if [e["epoch"] for e in res["epochs"]] != [0, 1] or steps != 64:
        raise AssertionError(f"expected 2 epochs of 32 steps, got {res['epochs']}")
    if launches < steps + evals:
        raise AssertionError(f"{launches} kernel launches for {steps} train and "
                             f"{evals} eval steps")
    losses = _logged_losses(os.path.join(out_dir, "train.log"))
    if len(losses) < 8 * 8 or not np.isfinite(losses).all():
        raise AssertionError(f"logged losses missing or non-finite: {losses[:16]}")
    paths = checkpoints.checkpoint_paths(out_dir)
    for key in ("final", "best"):
        if not os.path.exists(paths[key]):
            raise AssertionError(f"{paths[key]} was not written "
                                 f"(best IoU {res['best_prec']})")

    trained = res["state"].model.eval()
    fresh = FrustumConvNet(spec)
    checkpoints.load_checkpoint(paths["final"], fresh)
    fresh.to(device).eval()
    pts, one_hot, refs = split_batch(val_ds, range(32), spec.num_scales)
    inputs = (pts.to(device), one_hot.to(device), [r.to(device) for r in refs])
    with torch.no_grad():
        a, b = trained(*inputs), fresh(*inputs)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("model_final.pth does not reproduce the trained model")

    resumed = trainer.main(args + ["TRAIN.MAX_EPOCH", "3", "RESUME", "True"])
    if resumed["start_epoch"] != 2 or [e["epoch"] for e in resumed["epochs"]] != [2]:
        raise AssertionError(f"resume started at {resumed['start_epoch']}, ran "
                             f"{[e['epoch'] for e in resumed['epochs']]}")

    steady = res["epochs"][1]
    print(f"[trainer] 2 epochs of {steady['steps']} steps at batch 32 and "
          f"{evals} eval batches: {launches} kernel launches; {len(losses)} "
          f"logged losses, all finite; best IoU_0.7 {res['best_prec']:.4f} at "
          f"epoch {res['best_epoch']}; model_final.pth reloads with a "
          f"bit-identical forward; resumed at epoch 2")
    print(f"[trainer] steady epoch (epoch 1): {steady['ms_per_step']:.3f} ms/step, "
          f"{steady['frustums_per_s']:.1f} frustums/s over {steady['seconds']:.3f}s "
          f"(CUDA events); epoch 0 {res['epochs'][0]['ms_per_step']:.3f} ms/step")
    return {"counts": counts, "steady": steady, "final": paths["final"]}


def _train_family(tag: str, cfg_file: str, args: list, val_ds) -> dict:
    """``engine.train.main`` for 2 epochs at batch 32 on the card; checks
    finite logged losses, a kernel-1 launch on every train and eval step
    and ``model_final.pth``. Returns its launches, the steady epoch's stats
    and the checkpoint."""
    import math

    from frustum_convnet_tpu_torch.engine import checkpoints
    from frustum_convnet_tpu_torch.engine import train as trainer

    out_dir = args[args.index("OUTPUT_DIR") + 1]
    _reset_counts()
    res = trainer.main(["--cfg", os.path.join(ROOT, "cfgs", cfg_file), "--device", "cuda"]
                       + args + ["TRAIN.BATCH_SIZE", "32", "TEST.BATCH_SIZE", "32",
                                 "TRAIN.MAX_EPOCH", "2", "disp", "4",
                                 "USE_TFBOARD", "False"])
    launches = _counts()["group_depth_point_multi"]
    steps = [e["steps"] for e in res["epochs"]]
    evals = 2 * math.ceil(len(val_ds) / 32)
    if len(steps) != 2 or min(steps) < 4:
        raise AssertionError(f"[{tag}] expected 2 epochs of several steps: {res['epochs']}")
    if launches < sum(steps) + evals:
        raise AssertionError(f"[{tag}] {launches} kernel launches for {sum(steps)} "
                             f"train and {evals} eval steps")
    losses = _logged_losses(os.path.join(out_dir, "train.log"))
    if len(losses) < 16 or not np.isfinite(losses).all():
        raise AssertionError(f"[{tag}] logged losses missing or non-finite: {losses[:16]}")
    final = checkpoints.checkpoint_paths(out_dir)["final"]
    if not os.path.exists(final):
        raise AssertionError(f"[{tag}] {final} was not written")
    steady = res["epochs"][1]
    print(f"[{tag}] trainer: 2 epochs of {steps[0]} steps at batch 32 and {evals} "
          f"eval batches: {launches} kernel launches, {len(losses)} logged losses, "
          f"all finite; best {res['best_prec']:.4f} at epoch {res['best_epoch']}")
    print(f"[{tag}] trainer steady epoch (epoch 1): {steady['ms_per_step']:.3f} ms/step, "
          f"{steady['frustums_per_s']:.1f} frustums/s over {steady['seconds']:.3f}s "
          f"(CUDA events); epoch 0 {res['epochs'][0]['ms_per_step']:.3f} ms/step")
    return {"launches": launches, "steady": steady, "final": final}


def _serve_kitti(tag: str, cfg_file: str, raw: str, args: list, group: int = 2,
                 classes=("car",)) -> dict:
    """``engine.test.main`` on the card over a synthetic KITTI val split:
    checks a result file for every val id, finite values, detections, the
    evaluator's AP of each of ``classes`` and one kernel-1 launch for every
    forward."""
    from frustum_convnet_tpu_torch.engine import test as driver

    idx_path = os.path.join(raw, "image_sets", "val.txt")
    _reset_counts()
    out = driver.main(["--cfg", os.path.join(ROOT, "cfgs", cfg_file), "--device", "cuda",
                       "--gt_dir", os.path.join(raw, "training", "label_2"),
                       "--idx_path", idx_path] + args
                      + ["TEST.BATCH_SIZE", "32", "TPU.INFER_GROUP", str(group)])
    launches = _counts()["group_depth_point_multi"]
    stats = out["stats"]
    n_batches = -(-stats["frustums"] // 32)
    forwards = n_batches // group + n_batches % group + stats["overflow_reruns"]
    with open(idx_path) as f:
        n_ids = sum(1 for line in f if line.strip())
    files = sorted(os.listdir(out["result_dir"]))
    values = []
    for name in files:
        with open(os.path.join(out["result_dir"], name)) as f:
            values += [[float(v) for v in line.split()[3:]] for line in f if line.strip()]
    if len(files) != n_ids or not values or not np.isfinite(np.asarray(values)).all():
        raise AssertionError(f"[{tag}] {len(files)} result files for {n_ids} ids, "
                             f"{len(values)} finite detections expected")
    ap = out["ap"]
    if not ap or any(c not in ap or not np.isfinite(np.asarray(ap[c]["detection_3d"])).all()
                     for c in classes):
        raise AssertionError(f"[{tag}] the evaluator returned {ap!r}")
    if launches != forwards:
        raise AssertionError(f"[{tag}] {launches} kernel launches for {forwards} forwards")
    print(f"[{tag}] serving: {stats['frustums']} frustums in {n_batches} batches of 32, "
          f"groups of {group}: {launches} kernel launches (one a forward), "
          f"{stats['sections']} foreground sections, {stats['detections']} detections, "
          f"{len(values)} after NMS in {len(files)} files; "
          + "; ".join(f"{c} AP 3D {ap[c]['detection_3d']}" for c in classes))
    print(f"[{tag}] serving: end-to-end {stats['frustums_per_s']:.1f} frustums/s over "
          f"{stats['seconds']:.2f}s; steady-state {stats['steady_frustums_per_s']} frustums/s")
    return {"launches": launches, "stats": stats, "result_dir": out["result_dir"]}


def phase_refine(work: str, stage1_weights: str, num_frames: int = 64) -> dict:
    """The KITTI refine cascade through the port's CLIs on the card
    (``scripts/car_all.sh`` after stage-1 training, which phase 9 did):
    a synthetic raw KITTI, the stage-1 prep, stage-1 serving with phase 9's
    weights, the refine prep on its results, then ``cfgs/refine_car.yaml``
    trained at full width and served. Returns kernel-1 launches a path."""
    from frustum_convnet_tpu_torch.data.kitti import prepare, prepare_refine
    from frustum_convnet_tpu_torch.data.kitti.synthetic import make_synthetic_kitti
    from frustum_convnet_tpu_torch.data.provider_refine import FrustumRefineProvider

    t0 = time.time()
    raw = os.path.join(work, "kitti_raw")  # phase 5's split keeps work/kitti
    make_synthetic_kitti(raw, num_frames=num_frames, cars_per_frame=4, seed=SMOKE_SEED)
    stage1_pickles = os.path.join(work, "stage1_pickles")
    prepare.main(["--car_only", "--gen_train", "--gen_val", "--gen_val_rgb_detection",
                  "--data_root", raw, "--rgb_det_dir", os.path.join(raw, "rgb_detections"),
                  "--save_dir", stage1_pickles])
    print(f"[refine] synthetic KITTI of {num_frames} frames and the stage-1 prep in "
          f"{time.time() - t0:.1f}s")
    stage1_out = os.path.join(work, "car_train")
    stage1 = _serve_kitti("refine stage 1", "det_sample.yaml", raw, [
        "DATA.DATA_ROOT", stage1_pickles, "OUTPUT_DIR", stage1_out,
        "TEST.WEIGHTS", stage1_weights])

    refine_pickles = os.path.join(work, "refine_pickles")
    prepare_refine.main(["--car_only", "--gen_train", "--gen_val", "--gen_val_rgb_detection",
                         "--data_root", raw, "--save_dir", refine_pickles,
                         "--val_res_dir", stage1["result_dir"]])
    refine_out = os.path.join(work, "car_train_refine")
    args = ["DATA.DATA_ROOT", refine_pickles, "OUTPUT_DIR", refine_out]
    cfg = flagship_cfg(refine_pickles, "refine_car.yaml")
    rgb = FrustumRefineProvider(cfg, "val", from_rgb_detection=True)
    if len(rgb) < num_frames:  # the val frames hold 2 * num_frames cars
        raise AssertionError(f"the refine prep cut {len(rgb)} frustums from the stage-1 "
                             "results")
    train = _train_family("refine", "refine_car.yaml", args,
                          FrustumRefineProvider(cfg, "val"))
    serve = _serve_kitti("refine", "refine_car.yaml", raw,
                         args + ["TEST.WEIGHTS", train["final"]])
    return {"refine_stage1_serving": stage1["launches"],
            "refine_training": train["launches"], "refine_serving": serve["launches"]}


def phase_people(work: str, num_frames: int = 64) -> dict:
    """The people cascade (``scripts/people_all.sh``) through the port's CLIs
    on the card: a synthetic KITTI of Pedestrians and Cyclists, the stage-1
    prep (``--people_only``), ``cfgs/det_sample_people.yaml`` at full width
    (N=1024, 700/350/175/88 = 1313 sections) trained 2 epochs at batch 32 and
    served, the refine prep on its results, then ``cfgs/refine_people.yaml``
    (N=512) trained 2 epochs and served. Returns kernel-1 launches a path."""
    from frustum_convnet_tpu_torch import configs
    from frustum_convnet_tpu_torch.data.kitti import prepare, prepare_refine
    from frustum_convnet_tpu_torch.data.kitti.synthetic import make_synthetic_kitti
    from frustum_convnet_tpu_torch.data.provider import FrustumProvider
    from frustum_convnet_tpu_torch.data.provider_refine import FrustumRefineProvider

    t0 = time.time()
    raw = os.path.join(work, "people_raw")
    make_synthetic_kitti(raw, num_frames=num_frames, cars_per_frame=4, seed=SMOKE_SEED,
                         classes=("Pedestrian", "Cyclist"))
    stage1_pickles = os.path.join(work, "people_pickles")
    prepare.main(["--people_only", "--gen_train", "--gen_val", "--gen_val_rgb_detection",
                  "--data_root", raw, "--rgb_det_dir", os.path.join(raw, "rgb_detections"),
                  "--save_dir", stage1_pickles])
    print(f"[people] synthetic people KITTI of {num_frames} frames and the stage-1 prep "
          f"in {time.time() - t0:.1f}s")
    classes = ("pedestrian", "cyclist")
    cfg = flagship_cfg(stage1_pickles, "det_sample_people.yaml")
    refs = configs.get_model_spec(cfg).num_refs
    if refs != (700, 350, 175, 88):
        raise AssertionError(f"[people] the ladder has {refs} sections")
    args = ["DATA.DATA_ROOT", stage1_pickles, "OUTPUT_DIR", os.path.join(work, "people_train")]
    train = _train_family("people", "det_sample_people.yaml", args, FrustumProvider(cfg, "val"))
    stage1 = _serve_kitti("people", "det_sample_people.yaml", raw,
                          args + ["TEST.WEIGHTS", train["final"]], classes=classes)

    refine_pickles = os.path.join(work, "people_refine_pickles")
    # --gen_val as well: the refine trainer's validation epoch reads it
    prepare_refine.main(["--people_only", "--gen_train", "--gen_val", "--gen_val_rgb_detection",
                         "--data_root", raw, "--save_dir", refine_pickles,
                         "--val_res_dir", stage1["result_dir"]])
    args = ["DATA.DATA_ROOT", refine_pickles,
            "OUTPUT_DIR", os.path.join(work, "people_train_refine")]
    rcfg = flagship_cfg(refine_pickles, "refine_people.yaml")
    refine = _train_family("refine people", "refine_people.yaml", args,
                           FrustumRefineProvider(rcfg, "val"))
    served = _serve_kitti("refine people", "refine_people.yaml", raw,
                          args + ["TEST.WEIGHTS", refine["final"]], classes=classes)
    return {"people_training": train["launches"], "people_serving": stage1["launches"],
            "refine_people_training": refine["launches"],
            "refine_people_serving": served["launches"]}


# the summary keys of tools/run_synth_protocol.py:120-131 and
# tools/run_refine_protocol.py:118-131
PROTOCOL_KEYS = {
    "stage1": {"dtype", "epochs", "frames", "difficulty_mix", "overrides", "train_seconds",
               "ap", "ap_bev"},
    "refine": {"stage", "dtype", "epochs", "frames", "stage1", "weights", "overrides",
               "train_seconds", "ap", "ap_bev"}}


def phase_runners(work: str, frames: int = 128) -> dict:
    """The protocol runners at a short size on the card:
    ``run_synth_protocol.main`` (``--frames 128 --epochs 1``; IOU_THRESH 0.1,
    so that one epoch scores a best and ``model_best.pth`` is written), then
    ``run_refine_protocol.main`` on its output. Checks each
    ``PROTOCOL_RESULT`` (the JAX tools' keys, finite Car APs, the same
    ``protocol_result.json``) and a kernel-1 launch on every train, eval and
    serving forward. Returns kernel-1 launches a runner."""
    import math

    from frustum_convnet_tpu_torch.data.provider import FrustumProvider
    from frustum_convnet_tpu_torch.data.provider_refine import FrustumRefineProvider
    from frustum_convnet_tpu_torch.tools import run_refine_protocol, run_synth_protocol

    cache = os.path.join(work, "protocol")
    common = ["--frames", str(frames), "--epochs", "1", "--cache", cache, "--device", "cuda"]
    stage1_dir = os.path.join(cache, "run_float32_1ep")
    out = {}
    for stage, runner, args, cfg_file, provider in (
            ("stage1", run_synth_protocol, ["--override", "IOU_THRESH", "0.1"],
             "det_sample.yaml", FrustumProvider),
            ("refine", run_refine_protocol, ["--stage1", stage1_dir], "refine_car.yaml",
             FrustumRefineProvider)):
        _reset_counts()
        t0 = time.time()
        summary = runner.main(common + args)
        seconds = time.time() - t0
        launches = _counts()["group_depth_point_multi"]
        pickles = (run_synth_protocol.build_dataset(frames, 2, cache, 1)[1]  # cached
                   if stage == "stage1" else
                   os.path.join(cache, "refine_pickles_run_float32_1ep"))
        cfg = flagship_cfg(pickles, cfg_file)
        forwards = (len(provider(cfg, "train")) // 32 + math.ceil(len(provider(cfg, "val")) / 32)
                    + math.ceil(len(provider(cfg, "val", from_rgb_detection=True)) / 32 / 8))
        run_dir = stage1_dir if stage == "stage1" else os.path.join(
            cache, "run_refine_float32_1ep")
        with open(os.path.join(run_dir, "protocol_result.json")) as f:
            written = json.load(f)
        aps = summary.get("ap", {}).get("car", []) + summary.get("ap_bev", {}).get("car", [])
        if (set(summary) != PROTOCOL_KEYS[stage] or written != summary or len(aps) != 6
                or not np.isfinite(aps).all()):
            raise AssertionError(f"[runners] {stage}: PROTOCOL_RESULT {summary}, "
                                 f"protocol_result.json {written}")
        if launches < forwards:
            raise AssertionError(f"[runners] {stage}: {launches} kernel launches for at "
                                 f"least {forwards} train, eval and serving forwards")
        print(f"[runners] {stage}: PROTOCOL_RESULT {json.dumps(summary)}")
        print(f"[runners] {stage}: {launches} kernel launches (at least {forwards} "
              f"forwards), {seconds:.1f}s with the prep")
        out[f"runner_{stage}"] = launches
    return out


def phase_sunrgbd(work: str, num_frames: int = 64) -> dict:
    """SUN-RGBD through the port's CLIs on the card: synthetic scenes, the
    prep, ``cfgs/det_sample_sunrgbd.yaml`` trained at full width (N=2048, 5
    scales, K up to 256) and served by ``engine.test_sunrgbd`` ('top': one
    detection a frustum that survives the degenerate-size filter), then VOC
    AP. Returns kernel-1 launches a path."""
    from frustum_convnet_tpu_torch.data.provider_sunrgbd import FrustumSunrgbdProvider
    from frustum_convnet_tpu_torch.data.sunrgbd import prepare
    from frustum_convnet_tpu_torch.data.sunrgbd.synthetic import make_synthetic_sunrgbd
    from frustum_convnet_tpu_torch.engine import test_sunrgbd

    t0 = time.time()
    raw = os.path.join(work, "mysunrgbd")
    make_synthetic_sunrgbd(raw, num_frames=num_frames, objects_per_frame=4, seed=SMOKE_SEED)
    pickles = os.path.join(work, "sun_pickles")
    sets = os.path.join(raw, "image_sets")
    prepare.main(["--gen_train", "--gen_val", "--gen_val_rgb_detection", "--sunrgbd_dir", raw,
                  "--save_dir", pickles, "--train_idx", os.path.join(sets, "train.txt"),
                  "--val_idx", os.path.join(sets, "val.txt"),
                  "--det_file", os.path.join(raw, "det_val.txt")])
    print(f"[sunrgbd] synthetic scenes of {num_frames} frames and the prep in "
          f"{time.time() - t0:.1f}s")
    rgb_det = os.path.join(pickles, "sunrgbd_rgb_det_val.pickle")
    out_dir = os.path.join(work, "sunrgbd_train")
    args = ["DATA.DATA_ROOT", pickles, "OUTPUT_DIR", out_dir, "OVER_WRITE_TEST_FILE", rgb_det]
    cfg = flagship_cfg(pickles, "det_sample_sunrgbd.yaml")
    train = _train_family("sunrgbd", "det_sample_sunrgbd.yaml", args,
                          FrustumSunrgbdProvider(cfg, "val"))

    group = 2
    _reset_counts()
    out = test_sunrgbd.main(["--cfg", os.path.join(ROOT, "cfgs", "det_sample_sunrgbd.yaml"),
                             "--device", "cuda", "--sunrgbd_dir", raw,
                             "--val_idx", os.path.join(sets, "val.txt")] + args
                            + ["TEST.WEIGHTS", train["final"], "TEST.BATCH_SIZE", "32",
                               "TPU.INFER_GROUP", str(group)])
    launches = _counts()["group_depth_point_multi"]
    stats, aps = out["stats"], out["ap"]
    n_batches = -(-stats["frustums"] // 32)
    forwards = -(-n_batches // group)  # the tail group is padded to a full one
    with open(os.path.join(out["result_dir"], "sunrgbd_ap.json")) as f:
        written = json.load(f)
    if not aps or written["ap"] != aps or not np.isfinite(list(aps.values())).all():
        raise AssertionError(f"[sunrgbd] APs {aps!r}, sunrgbd_ap.json {written!r}")
    if not (stats["sections"] == stats["frustums"] > 0
            and stats["detections"] + stats["degenerate"] == stats["frustums"]):
        raise AssertionError(f"[sunrgbd] 'top' should give one detection a frustum "
                             f"that survives the size filter: {stats}")
    if launches != forwards:
        raise AssertionError(f"[sunrgbd] {launches} kernel launches for {forwards} forwards")
    print(f"[sunrgbd] serving ('top'): {stats['frustums']} frustums, groups of {group} "
          f"batches of 32: {launches} kernel launches (one a forward); "
          f"{stats['detections']} detections, {stats['degenerate']} degenerate; "
          f"mAP {written['mAP']:.4f} over {len(aps)} classes; sunrgbd_ap.json written")
    print(f"[sunrgbd] serving: end-to-end {stats['frustums_per_s']:.1f} frustums/s over "
          f"{stats['seconds']:.2f}s; steady-state {stats['steady_frustums_per_s']} frustums/s")
    return {"sunrgbd_training": train["launches"], "sunrgbd_serving": launches}


def phase_families(device, work: str) -> dict:
    """Kernel 1 at each other family's shapes, on B=32 batches of its
    provider (``grouping_cases.family_datasets``): bit for bit against its
    plain version (grouped and cnt), timed alone (``torch.profiler``) beside
    its bound and the plain version's time; bit for bit too at B=256, the
    bench's per-config batch, on a provider batch and on the bench's own
    fixture batch (``grouping_cases.flagship_case``); and each family's
    forward at batch 8, card against CPU. Returns {family: numbers}."""
    from frustum_convnet_tpu_torch.ops import grouping_cases, select_cuda
    from frustum_convnet_tpu_torch.ops.query_depth_point import group_depth_point_multi
    from frustum_convnet_tpu_torch.tools.time_grouping import (KERNEL_NAMES, alone_ms,
                                                               cuda_time_ms, kernel_bound)

    families = grouping_cases.family_datasets(os.path.join(ROOT, "cfgs"),
                                              os.path.join(work, "families"))
    def bit_for_bit(case, tag):
        pts, refs, dzs, ks = case
        t_pts = torch.from_numpy(pts).to(device)
        t_refs = [torch.from_numpy(r).to(device) for r in refs]
        got = select_cuda.group_depth_point_multi_cuda(t_pts, t_refs, dzs, ks)
        want = group_depth_point_multi(t_pts, t_refs, dzs, ks)
        torch.cuda.synchronize()
        err = 0.0
        for (g, c), (g0, c0) in zip(got, want):
            if g.shape != g0.shape or not torch.equal(c, c0) or not torch.equal(g, g0):
                raise AssertionError(f"[families] kernel 1 != plain version on {tag}")
            err = max(err, (g - g0).abs().max().item())
        return t_pts, t_refs, dzs, ks, err

    out = {}
    for family, (spec, dataset) in families.items():
        for case, tag in ((grouping_cases.provider_case(spec, dataset, 256, seed=SMOKE_SEED),
                           "provider"),
                          (grouping_cases.flagship_case(spec, 256), "bench fixture")):
            bit_for_bit(case, f"{family} B=256 {tag} batch")
        print(f"[families] {family} B=256: kernel 1 bit-identical to its plain version "
              f"on a provider batch and on the bench's fixture batch")
        t_pts, t_refs, dzs, ks, err = bit_for_bit(
            grouping_cases.provider_case(spec, dataset, 32, seed=SMOKE_SEED), family)
        kernel = lambda: select_cuda.group_depth_point_multi_cuda(t_pts, t_refs, dzs, ks)
        alone = alone_ms(kernel, KERNEL_NAMES["group_depth_point_multi"])
        plain_ms = cuda_time_ms(lambda: group_depth_point_multi(t_pts, t_refs, dzs, ks), 10)
        bound = kernel_bound("group_depth_point_multi", t_pts, t_refs, dzs, ks)
        out[family] = {"max_abs_err": err, "alone_ms": alone, "plain_ms": plain_ms,
                       "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                       "share": bound["bound_ms"] / alone}
        print(f"[families] {family} B=32 (N={spec.num_points}, M="
              f"{'/'.join(map(str, spec.num_refs))}, K={'/'.join(map(str, ks))}): kernel 1 "
              f"bit-identical to its plain version; alone {alone:.4f} ms, plain "
              f"{plain_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
              f"{bound['bytes'] / 1e6:.2f} MB), share {bound['bound_ms'] / alone:.1%}")
        phase_model(spec, device, seeded_model(spec), dataset, tag=f"families] [{family}")
    return out


HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _cuda_inputs(inputs, device):
    pts, one_hot, refs = inputs
    return pts.to(device), one_hot.to(device), [r.to(device) for r in refs]


def phase_precision_forward(spec, device, model, dataset) -> None:
    """The bfloat16 and float16 forward at batch 8, card against the port
    on the CPU, under the scale-free bound of ``tests/test_torch_precision``:
    the card's distance from the CPU at the half dtype is at most the CPU's
    own distance from float32 (relative L2, each head output)."""
    inputs = split_batch(dataset, range(8), spec.num_scales)
    with torch.no_grad():
        model.set_precision(None)
        ref = model(*inputs)
        for name, dtype in HALF.items():
            model.set_precision(dtype)
            cpu = model(*inputs)
            model.to(device)
            gpu = model(*_cuda_inputs(inputs, device))
            model.cpu()
            for out, c, g, r in zip(("cls_logits", "reg"), cpu, gpu, ref):
                g = g.cpu()
                if g.dtype != torch.float32 or g.shape != c.shape or not torch.isfinite(g).all():
                    raise AssertionError(f"[precision] {name} {out}: {g.dtype} "
                                         f"{tuple(g.shape)} or non-finite")
                dist, bound = _rel(g, c), _rel(c, r)
                if not dist <= bound:
                    raise AssertionError(f"[precision] {name} {out}: card vs CPU "
                                         f"{dist:.3e} over the bound {bound:.3e}")
                print(f"[precision] {name} forward {out}: card vs CPU {dist:.3e}, "
                      f"CPU {name} vs CPU float32 {bound:.3e} (the bound)")
    model.set_precision(None)


def _step_run(spec, base, batch, dev, **variant) -> tuple:
    """(losses, per-leaf gradients) of one train step before the optimizer,
    of ``base``'s weights in a model with ``variant``, on ``dev``."""
    from frustum_convnet_tpu_torch.models.net import FrustumConvNet
    from frustum_convnet_tpu_torch.parallel import train_step as ts

    m = FrustumConvNet(spec, **variant)
    m.load_state_dict(base.state_dict())
    m.to(dev)
    losses, _ = ts.loss_and_grads(m, spec, ts.TrainStepConfig(compute_metrics=False),
                                  ts.to_device(batch, dev))
    return ({k: v.item() for k, v in losses.items()},
            {n: p.grad.detach().cpu().double() for n, p in m.named_parameters()})


def phase_precision_steps(spec, device, model, dataset) -> None:
    """One batch-8 train step of each variant, card against the CPU.

    The half dtypes under a scale-free bound: the card's distance from the
    CPU at the half dtype is at most twice the CPU's own distance from
    float32, for the eight losses (a vector of relative deviations, each
    loss by its own value: a single loss can land near its float32 value by
    chance), for the gradient over all leaves and for each leaf. Twice,
    not once as on the CPU against JAX: cuDNN and cuBLAS sum in other
    orders than the CPU, so the card's half-precision roundings fall
    independently of the CPU's, and two independent draws of one noise lie
    sqrt(2) apart on average (measured on an H100: the float16 losses 1.5x,
    the bfloat16 worst leaf 1.34x). The float32 variants (ghost BatchNorm
    in groups of 4, FAST_BN, FAST_BN_FIRST, REMAT_POINTNET) under phase 8's
    tolerances (losses rtol 1e-4, each leaf 5e-3 in relative L2)."""
    batch = labeled_batch(dataset, range(8), spec.num_scales)
    ref_losses, ref_grads = _step_run(spec, model, batch, "cpu")
    names = sorted(ref_grads)

    def flat(grads):
        return torch.cat([grads[n].reshape(-1) for n in names])

    for tag, variant in (("bfloat16", dict(dtype=torch.bfloat16)),
                         ("float16", dict(dtype=torch.float16)),
                         ("ghost 4 of 8", dict(bn_group=4)),
                         ("FAST_BN", dict(fast_bn=True)),
                         ("FAST_BN_FIRST", dict(fast_bn_first=True)),
                         ("REMAT_POINTNET", dict(remat_pointnet=True))):
        l_cpu, g_cpu = _step_run(spec, model, batch, "cpu", **variant)
        l_card, g_card = _step_run(spec, model, batch, device, **variant)
        if not (np.isfinite(list(l_card.values())).all()
                and all(torch.isfinite(g).all() for g in g_card.values())):
            raise AssertionError(f"[precision] {tag} step: non-finite loss or gradient")
        keys = sorted(l_cpu)
        worst = max((_rel(g_card[n], g_cpu[n]), n) for n in names)
        if "dtype" in variant:
            d_loss, b_loss = (float(np.linalg.norm([(a[k] - b[k]) / abs(b[k]) for k in keys]))
                              for a, b in ((l_card, l_cpu), (l_cpu, ref_losses)))
            d_grad, b_grad = _rel(flat(g_card), flat(g_cpu)), _rel(flat(g_cpu), flat(ref_grads))
            leaf = max((_rel(g_card[n], g_cpu[n]) / max(_rel(g_cpu[n], ref_grads[n]), 1e-30), n)
                       for n in names)
            if not (d_loss <= 2 * b_loss and d_grad <= 2 * b_grad and leaf[0] <= 2.0):
                raise AssertionError(
                    f"[precision] {tag} step: losses {d_loss:.3e} (bound {b_loss:.3e}), "
                    f"gradient {d_grad:.3e} (bound {b_grad:.3e}), worst leaf {leaf}")
            print(f"[precision] {tag} step: card vs CPU losses {d_loss:.3e} (CPU vs float32 "
                  f"{b_loss:.3e}), gradient {d_grad:.3e} ({b_grad:.3e}), worst leaf "
                  f"{leaf[0]:.2f}x the CPU's distance ({leaf[1]}); bound 2x")
        else:
            d_loss = max(abs(l_card[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-6) for k in keys)
            if d_loss > 1e-4 or worst[0] > 5e-3:
                raise AssertionError(f"[precision] {tag} step: losses {d_loss:.3e}, "
                                     f"worst leaf {worst}")
            print(f"[precision] {tag} step: card vs CPU losses max rel {d_loss:.3e}, worst "
                  f"leaf {worst[0]:.3e} ({worst[1]}); vs plain BatchNorm total loss "
                  f"{l_cpu['total_loss']:.6f} / {ref_losses['total_loss']:.6f}")


def phase_precision_device(spec, device, model, dataset) -> dict:
    """For float32, bfloat16 and float16 at batch 32 (flagship, the
    metric-free step on a batch already on the card): the step's device
    time (the sum of its kernels' device times, ``torch.profiler``, over 8
    steps) beside its time by CUDA events over 8 steps without the
    profiler; and the peak ``torch.cuda.max_memory_allocated`` of one step
    after a first one (Adam's state allocated), with and without
    REMAT_POINTNET."""
    from torch.profiler import ProfilerActivity, profile

    from frustum_convnet_tpu_torch.models.net import FrustumConvNet
    from frustum_convnet_tpu_torch.parallel import train_step as ts

    batch = labeled_batch(dataset, range(32), spec.num_scales)
    cfg = ts.TrainStepConfig(compute_metrics=False)
    out = {}
    for name, dtype in (("float32", None), *HALF.items()):
        for remat in (False, True):
            m = FrustumConvNet(spec, dtype=dtype, remat_pointnet=remat)
            m.load_state_dict(model.state_dict())
            m.to(device)
            state = ts.TrainState(m, ts.make_optimizer(m.parameters(), cfg), ts.multistep_lr(cfg))
            step = ts.build_train_step(spec, cfg)
            b = ts.to_device(batch, device)
            for _ in range(3):
                step(state, b)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            before = torch.cuda.memory_allocated(device)
            step(state, b)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device)
            rec = {"peak_bytes": peak, "step_bytes": peak - before}
            if not remat:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(8):
                    step(state, b)
                end.record()
                end.synchronize()
                rec["ms_per_step"] = start.elapsed_time(end) / 8
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(8):
                        step(state, b)
                    torch.cuda.synchronize()
                busy = sum(getattr(e, "self_device_time_total", 0) or 0
                           for e in prof.key_averages())
                rec["device_ms_per_step"] = busy / 8 / 1e3 if busy else None
                rec["kernels_per_step"] = sum(e.count for e in prof.key_averages()) / 8
            out[(name, remat)] = rec
            del m, state, b
            torch.cuda.empty_cache()
        plain, rem = out[(name, False)], out[(name, True)]
        device_ms = plain["device_ms_per_step"]
        print(f"[precision] {name} step at batch 32 on prepared batches: "
              f"{plain['ms_per_step']:.3f} ms (CUDA events), device busy "
              f"{'not measured' if device_ms is None else f'{device_ms:.3f} ms'} over "
              f"{plain['kernels_per_step']:.0f} kernels; peak memory "
              f"{plain['peak_bytes'] / 2**20:.1f} MiB ({plain['step_bytes'] / 2**20:.1f} MiB "
              f"over the state), with REMAT_POINTNET {rem['peak_bytes'] / 2**20:.1f} MiB "
              f"({rem['step_bytes'] / 2**20:.1f} MiB)")
    return out


def phase_precision_trainer(work: str, pickle_dir: str, ap_f32, model, split) -> dict:
    """The trainer at batch 32, full width, on phase 9's split: bfloat16
    for 2 epochs of 32 steps, and float16 with TPU.F32_FINETUNE_EPOCHS 1
    over 3 epochs (the switch logged at epoch 2); then ``engine.test.main``
    at TPU.INFER_DTYPE bfloat16 on phase 5's split, its AP beside float32's.
    Returns kernel 1's launches on each of these paths."""
    from frustum_convnet_tpu_torch.engine import train as trainer

    paths = {}
    for tag, opts, epochs in (
            ("training_bf16", ["TPU.COMPUTE_DTYPE", "bfloat16"], 2),
            ("training_f16_f32_finetune", ["TPU.COMPUTE_DTYPE", "float16",
                                           "TPU.F32_FINETUNE_EPOCHS", "1"], 3)):
        out_dir = os.path.join(work, tag)
        _reset_counts()
        res = trainer.main(["--cfg", os.path.join(ROOT, "cfgs", "det_sample.yaml"),
                            "--device", "cuda", "DATA.DATA_ROOT", pickle_dir,
                            "OUTPUT_DIR", out_dir, "TRAIN.BATCH_SIZE", "32",
                            "TEST.BATCH_SIZE", "32", "disp", "8", "USE_TFBOARD", "False",
                            "TRAIN.MAX_EPOCH", str(epochs), *opts])
        paths[tag] = _counts()["group_depth_point_multi"]
        steps = sum(e["steps"] for e in res["epochs"])
        losses = _logged_losses(os.path.join(out_dir, "train.log"))
        if steps != 32 * epochs or paths[tag] < steps or not np.isfinite(losses).all():
            raise AssertionError(f"[precision] {tag}: {steps} steps, {paths[tag]} kernel "
                                 f"launches, losses {losses[:16]}")
        dtypes = [e["dtype"] for e in res["epochs"]]
        with open(os.path.join(out_dir, "train.log")) as f:
            switched = "epoch 2: switching to float32 fine-tune steps" in f.read()
        want = ["bfloat16"] * 2 if epochs == 2 else ["float16"] * 2 + ["float32"]
        if dtypes != want or switched != (epochs == 3):
            raise AssertionError(f"[precision] {tag}: epoch dtypes {dtypes}, switch "
                                 f"logged {switched}")
        for e in res["epochs"]:
            print(f"[precision] {tag} epoch {e['epoch']} ({e['dtype']}): "
                  f"{e['ms_per_step']:.3f} ms/step, {e['frustums_per_s']:.1f} frustums/s "
                  f"(CUDA events); IoU_0.7 {e['prec']:.4f}")
        print(f"[precision] {tag}: {paths[tag]} kernel launches, {len(losses)} logged "
              f"losses, all finite{'; the float32 switch logged at epoch 2' if switched else ''}")
    served = phase_driver(model, split, work, opts=["TPU.INFER_DTYPE", "bfloat16"],
                          tag="precision serving bfloat16")
    paths["serving_bf16"] = served["counts"]["group_depth_point_multi"]
    for key in ("detection", "detection_3d"):
        print(f"[precision] serving car AP {key} (easy, moderate, hard): bfloat16 "
              f"{served['ap'][key]}, float32 (phase 5) {ap_f32[key]}")
    return paths


def phase_precision_profiler(prof_f32: dict) -> dict:
    """``tools.profile_stages --dtype`` at batch 32 for bfloat16 and
    float16, beside phase 7's float32: the forward and the forward+decode
    ms."""
    from frustum_convnet_tpu_torch.tools import profile_stages

    times = {"float32": prof_f32}
    for name in HALF:
        times[name] = profile_stages.main(["--batch", "32", "--dtype", name])
    for name, t in times.items():
        print(f"[precision] profile_stages --dtype {name}: forward "
              f"{t['forward only'] * 1e3:.3f} ms, forward+decode "
              f"{t['full forward+decode'] * 1e3:.3f} ms, PointNet MLP stage "
              f"{t['pointnet MLP stage (grouping precomputed)'] * 1e3:.3f} ms at batch 32")
    return times


class FixedDraws:
    """A dataset whose item draws (point resampling, flip, shift) depend on
    the item alone. The loader keys a batch's draws by the process index, as
    the JAX loader does, so only such a dataset gives one process and N
    ranks the same global batches."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i, rng=None):
        return self.dataset.__getitem__(i, np.random.default_rng((11, int(i))))

    def __getattr__(self, name):
        return getattr(self.dataset, name)


def fixed_draws(make_datasets):
    """``engine.train.make_datasets`` with every split through ``FixedDraws``."""
    return lambda cfg: tuple(FixedDraws(d) for d in make_datasets(cfg))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Group:
    """The environment of ``parallel.mesh`` for rank ``rank`` of ``world``
    on a fresh localhost port, set while the block runs."""

    KEYS = ("FRUSTUM_COORDINATOR", "FRUSTUM_NUM_PROCESSES", "FRUSTUM_PROCESS_ID")

    def __init__(self, world: int = 1, rank: int = 0, port: int | None = None):
        self.values = (f"localhost:{port or _free_port()}", str(world), str(rank))

    def env(self) -> dict:
        return dict(zip(self.KEYS, self.values))

    def __enter__(self):
        os.environ.update(self.env())

    def __exit__(self, *exc):
        for k in self.KEYS:
            os.environ.pop(k, None)


def same_results(got_dir: str, want_dir: str, tag: str) -> tuple:
    """``tests/test_torch_infer.py``'s comparator: the same files, and in
    each the same lines in order, every %.4f field within one unit of its
    last digit and the %f score within two. Returns (lines compared, lines
    byte-identical)."""
    files = sorted(os.listdir(want_dir))
    if sorted(os.listdir(got_dir)) != files:
        raise AssertionError(f"[{tag}] result files differ from {want_dir}")
    n = same = 0
    for name in files:
        with open(os.path.join(got_dir, name)) as a, open(os.path.join(want_dir, name)) as b:
            got, want = a.read().splitlines(), b.read().splitlines()
        if len(got) != len(want):
            raise AssertionError(f"[{tag}] {name}: {len(got)} lines, want {len(want)}")
        for lg, lw in zip(got, want):
            fg, fw = lg.split(), lw.split()
            if (fg[:3] != fw[:3] or len(fg) != len(fw)
                    or np.abs(np.float64(fg[3:15]) - np.float64(fw[3:15])).max() > 1.01e-4
                    or abs(float(fg[15]) - float(fw[15])) > 2.01e-6):
                raise AssertionError(f"[{tag}] {name}: {lg!r} vs {lw!r}")
            n += 1
            same += lg == lw
    return n, same


def _param_distance(a: dict, b: dict) -> tuple:
    """(max abs difference, relative L2 norm) over the parameters of two
    state dicts (the running statistics left out, as JAX's test compares
    ``state.params``)."""
    diff = ref = worst = 0.0
    for k, v in b.items():
        if v.is_floating_point() and ".running_" not in k:
            d = a[k].double().cpu() - v.double().cpu()
            worst = max(worst, d.abs().max().item())
            diff += d.norm().item() ** 2
            ref += v.double().norm().item() ** 2
    return worst, (diff / ref) ** 0.5


def _first_losses(log_path: str) -> list:
    """The numbers on a trainer log's first disp line (step 1, before any update)."""
    with open(log_path) as f:
        for line in f:
            if " it 1/" in line and "total_loss" in line:
                words = line.split("total_loss", 1)[1].split()
                return [float(w) for w in words[::2]]
    raise AssertionError(f"no first step logged in {log_path}")


DP_STEPS = (2, 8)  # the 2-rank runs' steps at global batch 32
DP_BOUND = 2.5e-3  # JAX's 5e-3 over its 2 Adam steps (test_multihost.py:108), a step
# step 1 against one process, the worst leaf's relative L2: on an H100, 2
# ranks read 6.9e-3 and a world-1 group 2.6e-3 (sums in another order),
# and 6.0 with a BatchNorm backward not summed over the ranks (PERF.md §6)
DP_GRAD_BOUND = 5e-2


def dp_step(spec, pickle_dir: str, device, rank: int = 0, world: int = 1) -> dict:
    """One float32 train step at full width, before the optimizer, of
    ``seeded_model``'s weights on the split's first 32 train frustums
    (``FixedDraws``): rank ``rank``'s contiguous share of them, under the
    process group that is up, if any. Returns the global losses, each
    parameter's gradient after the all-reduce and the BatchNorm running
    statistics after the step's update, on the CPU."""
    from frustum_convnet_tpu_torch.engine import train as trainer
    from frustum_convnet_tpu_torch.parallel import train_step as ts

    train_ds = FixedDraws(trainer.make_datasets(flagship_cfg(pickle_dir))[0])
    lo, hi = rank * 32 // world, (rank + 1) * 32 // world
    batch = labeled_batch(train_ds, range(lo, hi), spec.num_scales)
    model = seeded_model(spec).to(device)
    losses, _ = ts.loss_and_grads(model, spec, ts.TrainStepConfig(compute_metrics=False),
                                  ts.to_device(batch, device))
    return {"losses": {k: v.item() for k, v in losses.items()},
            "grads": {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()},
            "stats": {k: v.detach().cpu().double() for k, v in model.state_dict().items()
                      if ".running_" in k}}


def step_distance(got: dict, want: dict) -> dict:
    """How far one ``dp_step`` lies from another: the largest relative
    difference of a loss, and the worst gradient leaf and running statistic
    in relative L2 norm, each as (distance, name)."""
    return {"losses": max((abs(v - want["losses"][k]) / max(abs(want["losses"][k]), 1e-30), k)
                          for k, v in got["losses"].items()),
            "grads": max((_rel(v, want["grads"][k]), k) for k, v in got["grads"].items()),
            "stats": max((_rel(v, want["stats"][k]), k) for k, v in got["stats"].items())}


def _fmt_distance(d: dict) -> str:
    return ", ".join(f"{k} {v:.3e} ({n})" for k, (v, n) in d.items())


def _dp_args(pickle_dir: str, out_dir: str) -> list:
    return ["--cfg", os.path.join(ROOT, "cfgs", "det_sample.yaml"), "--device", "cuda",
            "DATA.DATA_ROOT", pickle_dir, "OUTPUT_DIR", out_dir,
            "TRAIN.BATCH_SIZE", "32", "TEST.BATCH_SIZE", "32", "TRAIN.MAX_EPOCH", "1",
            "disp", "4", "TPU.METRIC_INTERVAL", "-1", "USE_TFBOARD", "False"]


def rank_main(job_path: str) -> int:
    """One rank of phase 16 (b), started by ``phase_data_parallel`` as
    ``chip_smoke.py --rank <job.json>`` with the environment of
    ``parallel.mesh``: joins the group over gloo on the one card, takes
    its share of ``dp_step`` on the job's ``grads`` split, trains each of
    the job's ``train`` splits and serves its ``serve`` split, and saves
    what it saw.
    With ``"nccl": true`` it only checks that NCCL refuses the layout."""
    sys.path.insert(0, ROOT)
    from frustum_convnet_tpu_torch import configs
    from frustum_convnet_tpu_torch.engine import test as driver
    from frustum_convnet_tpu_torch.engine import train as trainer
    from frustum_convnet_tpu_torch.parallel import mesh

    with open(job_path) as f:
        job = json.load(f)
    if job.get("nccl"):
        try:
            mesh.maybe_initialize_distributed("cuda")
        except RuntimeError as exc:
            print(f"refused: {exc}")
            return 0 if "two ranks on one device" in str(exc) else 1
        mesh.shutdown()
        return 1
    mesh.maybe_initialize_distributed("cuda", backend="gloo")
    driver.strict_fp32()
    rank = mesh.process_index()
    out = {"rank": rank, "world": mesh.process_count(), "train": []}
    try:
        if "grads" in job:
            spec = configs.get_model_spec(flagship_cfg())
            out["grads"] = dp_step(spec, job["grads"], mesh.rank_device("cuda"), rank,
                                   mesh.process_count())
        trainer.make_datasets = fixed_draws(trainer.make_datasets)
        for pickle_dir in job.get("train", ()):
            _reset_counts()
            res = trainer.main(_dp_args(pickle_dir, f"{pickle_dir}_out{rank}"))
            epoch = res["epochs"][0]
            out["train"].append({
                "launches": _counts()["group_depth_point_multi"], "backend": res["backend"],
                "steps": epoch["steps"], "ms_per_step": epoch["ms_per_step"],
                "val": epoch["val"], "train": epoch["train"],
                "state": {k: v.cpu() for k, v in res["state"].model.state_dict().items()}})
            del res
        if "serve" in job:
            _reset_counts()
            served = driver.main(job["serve"] + ["OUTPUT_DIR", f"{job['out']}_serve{rank}"])
            out["serve"] = {"launches": _counts()["group_depth_point_multi"],
                            "stats": served["stats"], "result_dir": served["result_dir"],
                            "ap": served["ap"]}
    finally:
        mesh.shutdown()
    torch.save(out, f"{job['out']}.rank{rank}.pt")
    return 0


def _run_ranks(job: dict, work: str, tag: str, world: int = 2, timeout: int = 600) -> list:
    """``world`` ranks of ``rank_main`` on the card; their return codes."""
    path = os.path.join(work, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, **_Group(world, rank, port).env())
        log = open(os.path.join(work, f"{tag}.rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                        "--rank", path], cwd=ROOT, env=env,
                                       stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    codes = [p.returncode for p, _ in procs]
    for rank, code in enumerate(codes):
        with open(os.path.join(work, f"{tag}.rank{rank}.log")) as f:
            tail = f.read()[-3000:]
        print(f"[data parallel] {tag} rank {rank} exit {code}; its log ends:\n{tail}"
              if code else f"[data parallel] {tag} rank {rank} exit 0")
    return codes


def phase_dp_gradients(spec, work: str, train_dir: str, device) -> dict:
    """Phase 16's step-1 check, before Adam's near-sign steps blur a
    difference: ``dp_step`` on the first 32 frustums of ``train_dir``
    without a group twice (the card's own distance from run to run), in a
    world-1 NCCL group (the group's ``mean2 - mean^2`` variance) and on
    two ranks sharing the card over gloo (16 frustums each, the ranks'
    gradients bitwise equal). Against the first run without a group, the
    losses lie within 1e-4 and every gradient leaf and running statistic
    within ``DP_GRAD_BOUND`` in relative L2 norm. Returns the distances."""
    from frustum_convnet_tpu_torch.parallel import mesh

    plain, again = (dp_step(spec, train_dir, device) for _ in range(2))
    with _Group():
        mesh.maybe_initialize_distributed("cuda")
        try:
            backend = mesh.backend()
            grouped = dp_step(spec, train_dir, device)
        finally:
            mesh.shutdown()
    prefix = os.path.join(work, "dp2_grads")
    codes = _run_ranks({"grads": train_dir, "out": prefix}, work, "dp2_grads")
    if codes != [0, 0]:
        raise AssertionError(f"[data parallel] 2 ranks' step exited {codes}")
    r0, r1 = (torch.load(f"{prefix}.rank{r}.pt", weights_only=False)["grads"] for r in (0, 1))
    if any(not torch.equal(v, r1["grads"][k]) for k, v in r0["grads"].items()):
        raise AssertionError("[data parallel] the 2 ranks' summed gradients differ")
    dist = {"the card again": step_distance(again, plain),
            f"a world-1 {backend} group": step_distance(grouped, plain),
            "2 ranks over gloo": step_distance(r0, plain)}
    for tag, d in dist.items():
        print(f"[data parallel] step 1 at batch 32, {tag} against one process: "
              f"{_fmt_distance(d)} (bounds 1e-4 losses, {DP_GRAD_BOUND:.0e} leaves)")
    bad = [tag for tag, d in dist.items() if d["losses"][0] > 1e-4
           or max(d["grads"][0], d["stats"][0]) > DP_GRAD_BOUND]
    if bad or backend != "nccl":
        raise AssertionError(f"[data parallel] step 1 off one process: {bad}, "
                             f"world-1 backend {backend}")
    return dist


def dp_gradients_main() -> int:
    """``chip_smoke.py --dp-gradients``: phase 16's step-1 check alone, on
    the first 32 frustums of phase 9's split (the same seed)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from frustum_convnet_tpu_torch import configs
    from frustum_convnet_tpu_torch.engine import test as driver

    driver.strict_fp32()
    spec = configs.get_model_spec(flagship_cfg())
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as work:
        train_dir = os.path.join(work, "train_pickles")
        make_train_split(train_dir, spec, num_train=32, num_val=32)
        phase_dp_gradients(spec, work, train_dir, torch.device("cuda", 0))
    return 0


def phase_data_parallel(spec, work: str, train_dir: str, model, split, served: dict,
                        trained: dict, card: str) -> dict:
    """Phase 16: the data-parallel layer on the one card. The step-1 check
    (``phase_dp_gradients``); (a) world 1 over
    NCCL through the CLIs: phase 9's training (its split, batch 32, 2
    epochs), its parameters against phase 9's beside a second run of phase
    9's, and serving phase 5's split, with phase 9's setup and with
    phase 5's weights, whose files must match phase 5's; (b) two ranks
    sharing the card over gloo: 2 and 8 steps at global batch 32 (16 a
    rank), bitwise-equal ranks within each run, parameters within
    ``DP_BOUND`` a step of one process on the same global batches, then
    phase 5's split
    served on both ranks in groups of one batch with one process's files and
    AP; NCCL refuses two ranks on
    the card. Returns kernel 1's launches on each path."""
    import math

    from frustum_convnet_tpu_torch.engine import checkpoints
    from frustum_convnet_tpu_torch.engine import test as driver
    from frustum_convnet_tpu_torch.engine import train as trainer
    from frustum_convnet_tpu_torch.models.net import FrustumConvNet
    from frustum_convnet_tpu_torch.parallel import mesh

    phase_dp_gradients(spec, work, train_dir, torch.device("cuda", 0))
    paths = {}
    # (a) world 1 over NCCL: the trainer, as phase 9 ran it
    out_dir = os.path.join(work, "dp1_train")
    args = ["--cfg", os.path.join(ROOT, "cfgs", "det_sample.yaml"), "--device", "cuda",
            "DATA.DATA_ROOT", train_dir, "TRAIN.BATCH_SIZE", "32",
            "TEST.BATCH_SIZE", "32", "disp", "8", "TPU.METRIC_INTERVAL", "-1",
            "USE_TFBOARD", "False", "TRAIN.MAX_EPOCH", "2"]
    calls = mesh.all_reduce.calls
    with _Group():
        _reset_counts()
        res = trainer.main(args + ["OUTPUT_DIR", out_dir])
        paths["dp_world1_training"] = _counts()["group_depth_point_multi"]
    collectives = mesh.all_reduce.calls - calls
    _, val_ds = trainer.make_datasets(flagship_cfg(train_dir))
    steps = sum(e["steps"] for e in res["epochs"])
    evals = 2 * math.ceil(len(val_ds) / 32)
    losses = _logged_losses(os.path.join(out_dir, "train.log"))
    if (res["backend"], res["world"]) != ("nccl", 1) or mesh.initialized():
        raise AssertionError(f"[data parallel] world-1 group: {res['backend']}, "
                             f"world {res['world']}, left up {mesh.initialized()}")
    if steps != 64 or paths["dp_world1_training"] < steps + evals:
        raise AssertionError(f"[data parallel] {steps} steps, "
                             f"{paths['dp_world1_training']} kernel launches")
    if collectives < 2 * steps or len(losses) < 64 or not np.isfinite(losses).all():
        raise AssertionError(f"[data parallel] {collectives} NCCL all-reduces, "
                             f"losses {losses[:16]}")
    # phase 9 once more without a group: the 64-step distance the card's own
    # nondeterminism leaves, the baseline for the group's
    again_dir = os.path.join(work, "dp0_train")
    trainer.main(args + ["OUTPUT_DIR", again_dir])
    final, again = (checkpoints.checkpoint_paths(d)["final"] for d in (out_dir, again_dir))
    grouped, repeat, plain = (torch.load(p, map_location="cpu", weights_only=True)["state_dict"]
                              for p in (final, again, trained["final"]))
    worst, rel = _param_distance(grouped, plain)
    worst0, rel0 = _param_distance(repeat, plain)
    steady = res["epochs"][1]
    print(f"[data parallel] world 1 over NCCL, trainer 2 epochs of 32 steps at batch 32 "
          f"and {evals} eval batches: {paths['dp_world1_training']} kernel launches, "
          f"{collectives} NCCL all-reduces ({collectives / (steps + evals):.1f} a step), "
          f"{len(losses)} logged losses, all finite")
    print(f"[data parallel] {card}: world-1 group steady {steady['ms_per_step']:.3f} ms/step, "
          f"without a group (phase 9) {trained['steady']['ms_per_step']:.3f} ms/step "
          f"(CUDA events)")
    print(f"[data parallel] world-1 group against phase 9 after 64 Adam steps: "
          f"parameters max abs {worst:.3e}, relative L2 {rel:.3e}; phase 9 run again "
          f"without a group: max abs {worst0:.3e}, relative L2 {rel0:.3e}")

    # (a) serving under the group: phase 9's setup trained once more, and
    # phase 5's weights, whose files must match phase 5's
    weights_model = FrustumConvNet(spec)
    checkpoints.load_checkpoint(final, weights_model)
    with _Group():
        trained_serving = phase_driver(weights_model, split, work, tag="dp world-1 serving",
                                       weights_name="dp1_final.pth")
    with _Group():
        same = phase_driver(model, split, work, tag="dp world-1 serving phase-5 weights",
                            weights_name="dp1_phase5.pth")
    paths["dp_world1_serving"] = trained_serving["counts"]["group_depth_point_multi"]
    paths["dp_world1_serving_phase5_weights"] = same["counts"]["group_depth_point_multi"]
    n_lines, n_same = same_results(same["result_dir"], served["result_dir"], "data parallel")
    if same["ap"] != served["ap"]:
        raise AssertionError(f"[data parallel] world-1 AP {same['ap']} vs {served['ap']}")
    print(f"[data parallel] world-1 serving with phase 5's weights: {n_lines} result lines "
          f"match phase 5's in order ({n_same} byte-identical), equal AP")

    # (b) two ranks on the card over gloo
    runs = []
    for n in DP_STEPS:
        d = os.path.join(work, f"dp2_{n}steps")
        make_train_split(d, spec, num_train=32 * n, num_val=80)
        runs.append(d)
    # serving in groups of one batch: a batch left out of a group (a rank's
    # or a process's last) takes the full path, whose host-built ladders lie
    # a rounding from the grouped path's device-built ones, so one process
    # and two ranks would send different batches down different paths
    weights = os.path.join(work, "dp1_phase5.pth")
    serve_args = ["--cfg", os.path.join(ROOT, "cfgs", "det_sample.yaml"), "--device", "cuda",
                  "--gt_dir", split["gt_dir"], "--idx_path", split["idx_path"],
                  "DATA.DATA_ROOT", split["pickle_dir"], "TEST.BATCH_SIZE", "32",
                  "TPU.INFER_GROUP", "1", "TEST.WEIGHTS", weights]
    prefix = os.path.join(work, "dp2")
    codes = _run_ranks({"train": runs, "serve": serve_args, "out": prefix}, work, "dp2")
    if codes != [0, 0]:
        raise AssertionError(f"[data parallel] 2 ranks exited {codes}")
    ranks = [torch.load(f"{prefix}.rank{r}.pt", weights_only=False) for r in (0, 1)]
    trainer_make = trainer.make_datasets
    trainer.make_datasets = fixed_draws(trainer_make)
    try:
        single = []
        for d in runs:
            res = trainer.main(_dp_args(d, f"{d}_single"))
            single.append({k: v.cpu() for k, v in res["state"].model.state_dict().items()})
            del res
    finally:
        trainer.make_datasets = trainer_make
    paths["dp_2rank_training"] = 0
    for i, (n, d) in enumerate(zip(DP_STEPS, runs)):
        t0, t1 = (r["train"][i] for r in ranks)
        if any(not torch.equal(v, t1["state"][k]) for k, v in t0["state"].items()):
            raise AssertionError(f"[data parallel] {n} steps: the ranks' states differ")
        if (t0["backend"], t0["steps"], t0["val"]) != ("gloo", n, t1["val"]):
            raise AssertionError(f"[data parallel] {n} steps: {t0['backend']}, "
                                 f"{t0['steps']} steps, val {t0['val']} vs {t1['val']}")
        first, first_single = (_first_losses(os.path.join(p, "train.log"))
                               for p in (f"{d}_out0", f"{d}_single"))
        step1 = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(first, first_single))
        worst, rel = _param_distance(t0["state"], single[i])
        if step1 > 1e-4 or not worst <= DP_BOUND * n:
            raise AssertionError(f"[data parallel] {n} steps: step-1 losses and metrics "
                                 f"{step1:.3e} from one process (bound 1e-4), parameters "
                                 f"{worst:.3e} (bound {DP_BOUND * n:.1e})")
        if not os.path.exists(os.path.join(f"{d}_out0", "train.log")) or os.path.exists(f"{d}_out1"):
            raise AssertionError(f"[data parallel] {n} steps: not only the chief wrote")
        if n == max(DP_STEPS):
            paths["dp_2rank_training"] = t0["launches"] + t1["launches"]
        print(f"[data parallel] 2 ranks over gloo, {n} steps at global batch 32: ranks "
              f"bitwise equal; against one process, step-1 losses and metrics within "
              f"{step1:.3e} (bound 1e-4), parameters max abs {worst:.3e} (bound "
              f"{DP_BOUND * n:.1e}), relative L2 {rel:.3e}; {t0['launches']} + "
              f"{t1['launches']} kernel launches")
        print(f"[data parallel] {card}: 2 ranks sharing the card, {n} steps: "
              f"{t0['ms_per_step']:.3f} / {t1['ms_per_step']:.3f} ms/step (rank 0 / 1, "
              f"CUDA events, first epoch)")
    one = driver.main(serve_args + ["OUTPUT_DIR", f"{prefix}_serve_single"])
    s0, s1 = (r["serve"] for r in ranks)
    if s1["result_dir"] is not None or os.path.exists(f"{prefix}_serve1"):
        raise AssertionError("[data parallel] rank 1 wrote serving results")
    if s0["stats"]["frustums"] + s1["stats"]["frustums"] != served["frustums"]:
        raise AssertionError(f"[data parallel] ranks served {s0['stats']['frustums']} + "
                             f"{s1['stats']['frustums']} frustums")
    n_lines, n_same = same_results(s0["result_dir"], one["result_dir"],
                                   "data parallel 2 ranks")
    if s0["ap"] != one["ap"]:
        raise AssertionError(f"[data parallel] 2-rank AP {s0['ap']} vs {one['ap']}")
    paths["dp_2rank_serving"] = s0["launches"] + s1["launches"]
    print(f"[data parallel] 2 ranks serving phase 5's split in groups of one batch: "
          f"{s0['stats']['frustums']} + {s1['stats']['frustums']} frustums, "
          f"{s0['launches']} + {s1['launches']} kernel launches; {n_lines} result lines "
          f"match one process's in order ({n_same} byte-identical), equal AP; only rank "
          f"0 wrote")
    print(f"[data parallel] {card}: serving in groups of one batch, steady "
          f"{s0['stats']['steady_frustums_per_s']} / {s1['stats']['steady_frustums_per_s']} "
          f"frustums/s on ranks 0 / 1 sharing the card, one process "
          f"{one['stats']['steady_frustums_per_s']}")

    codes = _run_ranks({"nccl": True}, work, "dp2_nccl", timeout=300)
    if codes != [0, 0]:
        raise AssertionError(f"[data parallel] NCCL with 2 ranks on the card: exits {codes}")
    print("[data parallel] NCCL with 2 ranks on one card: refused on both ranks")
    return paths



NMS_CASES = ((24, 16), (256, 64))  # (boxes, max_out): the JAX test's set and a wide one
NMS_THRESH = 0.3


def nms_boxes(rng, n: int):
    """``tests/test_box_overlaps_nms_jax.py:58-62``'s generator: centers,
    sizes (lwh), headings and scores, float32."""
    centers = np.column_stack([rng.uniform(-6, 6, n), rng.uniform(-1, 1, n),
                               rng.uniform(-6, 6, n)]).astype(np.float32)
    sizes = rng.uniform(1, 4, (n, 3)).astype(np.float32)
    headings = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    return centers, sizes, headings, scores


def _host_ms(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def phase_device_nms(device) -> dict:
    """Phase 17 (c): ``ops/nms_device.rotate_nms_3d_device`` on the card
    against the port's host NMS (``core/nms.rotate_nms_3d`` in float64 and
    the native ``ops/native.rotate_nms_3d`` the drivers run): equal keep
    lists on the seeded sets of ``NMS_CASES``; the greedy loop issues no
    host sync (``torch.cuda.set_sync_debug_mode("error")``); timed at
    n=256 with CUDA events beside the host NMS's time."""
    from frustum_convnet_tpu_torch.core import nms as host_nms
    from frustum_convnet_tpu_torch.core.geometry import box3d_corners
    from frustum_convnet_tpu_torch.core.iou import iou_matrix_3d
    from frustum_convnet_tpu_torch.ops import native, nms_device
    from frustum_convnet_tpu_torch.tools.time_grouping import cuda_time_ms

    if not native.native_available():
        raise AssertionError("[entry points] the native NMS did not build")
    rng = np.random.default_rng(3)
    out = {}
    for n, max_out in NMS_CASES:
        boxes = nms_boxes(rng, n)
        c, s, h, sc = (torch.from_numpy(a).to(device) for a in boxes)
        valid = torch.ones(n, dtype=torch.bool, device=device)
        iou = iou_matrix_3d(box3d_corners(c, h, s), box3d_corners(c, h, s))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            keep_loop, _ = nms_device.greedy_nms_from_iou(iou, sc, valid, NMS_THRESH, max_out)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        keep, cnt = nms_device.rotate_nms_3d_device(c, s, h, sc, valid, NMS_THRESH, max_out)
        keep, cnt = keep.cpu(), int(cnt)
        dets = np.column_stack(boxes).astype(np.float64)
        want = host_nms.rotate_nms_3d(dets, NMS_THRESH, top_k=max_out)
        want_native = native.rotate_nms_3d(dets, NMS_THRESH, top_k=max_out)
        if (keep[:cnt].tolist() != want or want_native != want
                or not torch.equal(keep_loop.cpu(), keep) or (keep[cnt:] != -1).any()):
            raise AssertionError(f"[entry points] device NMS n={n}: {keep.tolist()} ({cnt}), "
                                 f"host {want}, native {want_native}")
        rec = {"kept": cnt}
        if n == 256:
            rec["device_ms"] = cuda_time_ms(lambda: nms_device.rotate_nms_3d_device(
                c, s, h, sc, valid, NMS_THRESH, max_out), 20)
            rec["native_ms"] = _host_ms(lambda: native.rotate_nms_3d(dets, NMS_THRESH, max_out), 5)
            rec["numpy_ms"] = _host_ms(lambda: host_nms.rotate_nms_3d(dets, NMS_THRESH, max_out), 1)
        out[n] = rec
        print(f"[entry points] device NMS n={n} max_out={max_out}: {cnt} kept, the host's "
              f"keep list (core/nms and ops/native), no host sync in the greedy loop"
              + (f"; {rec['device_ms']:.3f} ms on the card (CUDA events, 20 calls), "
                 f"native host {rec['native_ms']:.3f} ms, numpy host {rec['numpy_ms']:.3f} ms"
                 if n == 256 else ""))
    return out


def phase_entry_points(device, card: str) -> dict:
    """Phase 17: the port's entry points that no driver runs. (a)
    ``graft_entry.entry()`` on the card against ``entry(device="cpu")``
    with the same seeded weights, every decoded output within atol/rtol
    1e-4, one kernel-1 launch; (b) ``graft_entry.dryrun_multichip(2)``: 2
    gloo ranks sharing the card, the audit of each level's step, kernel 1
    on every forward; (c) the device NMS (``phase_device_nms``); (d)
    ``tools.profile_train`` at batch 32 in float32 and bfloat16, finite
    rows and kernel 1 on every timed call; (e) ``tools.profile_mlp`` at
    batch 256. Returns kernel 1's launches on the entry, dry-run and
    profiler paths."""
    from frustum_convnet_tpu_torch import graft_entry
    from frustum_convnet_tpu_torch.tools import profile_mlp, profile_train

    paths = {}
    fn, args = graft_entry.entry()
    cpu_fn, cpu_args = graft_entry.entry(device="cpu")
    want = cpu_fn(*cpu_args)
    _reset_counts()
    got = fn(*args)
    paths["entry"] = _counts()["group_depth_point_multi"]
    worst = 0.0
    for k, w in want.items():
        g = got[k].cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"[entry points] entry() {k}: {tuple(g.shape)} or non-finite")
        torch.testing.assert_close(g, w, **MODEL_TOL)
        worst = max(worst, (g - w).abs().max().item())
    if paths["entry"] != 1:
        raise AssertionError(f"[entry points] entry() launched kernel 1 {paths['entry']} times")
    print(f"[entry points] entry() on the card against the CPU: {len(want)} outputs, max abs "
          f"{worst:.3e} (atol/rtol 1e-4), 1 kernel-1 launch")

    dry = graft_entry.dryrun_multichip(2)
    paths["dryrun_multichip"] = dry["launches"]
    if dry["backend"] != "gloo" or dry["launches"] != dry["forwards"]:
        raise AssertionError(f"[entry points] dry-run over {dry['backend']}: "
                             f"{dry['launches']} kernel-1 launches for {dry['forwards']} forwards")
    print(f"[entry points] dryrun_multichip(2) on {card}: 2 gloo ranks sharing the card, "
          f"audit {dry['audits']}, {dry['launches']} kernel-1 launches for "
          f"{dry['forwards']} forwards")

    nms = phase_device_nms(device)

    paths["profile_train"] = 0
    train_rows = {}
    for dtype in ("float32", "bfloat16"):
        _reset_counts()
        res = profile_train.main(["--batch", "32", "--dtype", dtype])
        launches = _counts()["group_depth_point_multi"]
        paths["profile_train"] += launches
        if launches < res["forwards"] or not all(np.isfinite(v) for v in res["rows"].values()):
            raise AssertionError(f"[entry points] profile_train {dtype}: {launches} kernel-1 "
                                 f"launches for {res['forwards']} calls, rows {res['rows']}")
        train_rows[dtype] = res
        print(f"[entry points] profile_train --dtype {dtype} on {card}: {launches} kernel-1 "
              f"launches for {res['forwards']} timed calls")
    mlp = profile_mlp.main(["--batch", "256"])
    print(f"[entry points] profile_mlp --batch 256 on {card}: TOTAL float32 "
          f"{mlp['float32']['TOTAL'] * 1e3:.3f} ms, bfloat16 {mlp['bfloat16']['TOTAL'] * 1e3:.3f} ms")
    return {"paths": paths, "nms": nms, "profile_train": train_rows, "profile_mlp": mlp}


BENCH_BLOCKS = 14  # the bench's blocks: 3 inference, serving, 3 + 2 train, 3 + 2 configs


def _positive(x) -> bool:
    return (isinstance(x, (int, float)) and not isinstance(x, bool)
            and bool(np.isfinite(x)) and x > 0)


def _numbers(obj, path: str = ""):
    """(path, number) of every number inside a JSON value."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _numbers(v, f"{path}.{k}" if path else k)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _numbers(v, f"{path}[{i}]")
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield path, obj


def phase_bench(card: str, work: str) -> dict:
    """Phase 18: the port's bench on the card. ``bench.main`` with ``--iters
    3 --trials 1``: every block measured (nothing skipped), each block's
    rate, TFLOP/s and MFU finite and positive with kernel 1 launched in it,
    and every measured number of the last line finite and positive (not
    the baseline estimate's constants or the headline recipe's fields);
    then ``tools.bench_models --only refine_people --batches 32 --iters 3``
    and ``tools.bench_driver`` on a 64-frame split at batch 4, ``--sweep
    8:2``, each rate finite and positive with kernel-1 launches. Returns
    kernel 1's launches on the three paths and the bench's last line."""
    from frustum_convnet_tpu_torch import bench
    from frustum_convnet_tpu_torch.tools import bench_driver, bench_models

    torch.cuda.empty_cache()
    paths = {}
    t0 = time.time()
    _reset_counts()
    res = bench.main(["--iters", "3", "--trials", "1"])
    paths["bench"] = _counts()["group_depth_point_multi"]
    blocks, result = res["blocks"], res["result"]
    bad = [line["block"] for line in blocks
           if not all(_positive(line[k])
                      for k in ("value", "tflops_per_sec", "mfu_pct", "launches"))]
    bad += [path for path, x in _numbers(result) if not _positive(x)
            and not path.startswith(("baseline_estimate.", "train_throughput.recipe."))]
    if result["skipped"] or len(blocks) != BENCH_BLOCKS or bad:
        raise AssertionError(f"[bench] {len(blocks)} blocks, skipped {result['skipped']}, "
                             f"not positive or no kernel-1 launch: {bad}")
    print(f"[bench] bench.main --iters 3 --trials 1 on {card}: {len(blocks)} blocks in "
          f"{time.time() - t0:.1f}s, {paths['bench']} kernel-1 launches (fewest in a "
          f"block {min(line['launches'] for line in blocks)}); inference "
          f"{result['value']:.1f} frustums/s at batch {result['batch']}, train "
          f"{result['train_throughput']['value']:.1f}")

    t0 = time.time()
    _reset_counts()
    rows = bench_models.main(["--only", "refine_people", "--batches", "32", "--iters", "3"])
    paths["bench_models"] = _counts()["group_depth_point_multi"]
    if (len(rows) != 1 or not all(_positive(r) for r in rows[0][2].values())
            or paths["bench_models"] <= 0):
        raise AssertionError(f"[bench] bench_models: {rows}, "
                             f"{paths['bench_models']} kernel-1 launches")
    print(f"[bench] bench_models --only refine_people --batches 32 --iters 3 in "
          f"{time.time() - t0:.1f}s, {paths['bench_models']} kernel-1 launches")

    t0 = time.time()
    _reset_counts()
    lines = bench_driver.main(["--frames", "64", "--batch", "4", "--sweep", "8:2",
                               "--cache", os.path.join(work, "bench_driver")])
    paths["bench_driver"] = _counts()["group_depth_point_multi"]
    keys = ("frustums", "frustums_per_s", "steady_frustums_per_s", "launches")
    if len(lines) != 1 or not all(_positive(lines[0][k]) for k in keys):
        raise AssertionError(f"[bench] bench_driver: {lines}")
    print(f"[bench] bench_driver --frames 64 --batch 4 --sweep 8:2 in "
          f"{time.time() - t0:.1f}s, {paths['bench_driver']} kernel-1 launches")
    return {"paths": paths, "bench": result}


def _standalone() -> str | None:
    """Phases 1 and 2 for a phase run alone: the card's ``nvidia-smi`` name
    and power limit, TF32 off, the kernel library built; None without a
    card."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return None
    sys.path.insert(0, ROOT)
    from frustum_convnet_tpu_torch.engine import test as driver
    from frustum_convnet_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] {card}")
    driver.strict_fp32()
    _build.load_library("group_depth_point")
    return card


def entry_points_main() -> int:
    """``chip_smoke.py --entry-points``: phases 1, 2 and 17 alone."""
    card = _standalone()
    if card is None:
        return 1
    phase_entry_points(torch.device("cuda", 0), card)
    return 0


def bench_main() -> int:
    """``chip_smoke.py --bench``: phases 1, 2 and 18 alone."""
    card = _standalone()
    if card is None:
        return 1
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as work:
        t0 = time.time()
        phase_bench(card, work)
        print(f"[bench] phase 18 in {time.time() - t0:.1f}s")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from frustum_convnet_tpu_torch import configs
    from frustum_convnet_tpu_torch.engine import test as driver
    from frustum_convnet_tpu_torch.ops import _build, select_cuda

    # 1. device
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}")
    driver.strict_fp32()

    # 2. build
    t0 = time.time()
    _build.load_library("group_depth_point")
    print(f"[build] group_depth_point.cu ready in {time.time() - t0:.1f}s")
    for line in _build.build_logs.get("group_depth_point", "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # 3. kernel against the plain version
    spec = configs.get_model_spec(flagship_cfg())
    kernel = phase_kernel(spec, device)

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as work:
        t0 = time.time()
        split = make_val_split(work, spec)
        dataset = driver.make_dataset(flagship_cfg(split["pickle_dir"]))
        model = seeded_model(spec)
        fit_cls_head(spec, model, dataset, split["fg_labels"], device)
        print(f"[data] synthetic val split of {len(dataset)} frustums and "
              f"fitted weights in {time.time() - t0:.1f}s")
        # 4. model on the card against the port on the CPU
        phase_model(spec, device, model, dataset)
        # 5. the serving driver, through its CLI entry point
        served = phase_driver(model, split, work)
        serve_counts = served["counts"]
        print(f"[driver] kernel launches on the serving path: {serve_counts}")
        # 6. kernels 2 and 3 against their plain versions
        modes = phase_modes(spec, device)
        # 7. the stage profiler, which runs kernels 1, 2 and 3
        prof_launches, prof_times = phase_profiler()

        t0 = time.time()
        train_dir = os.path.join(work, "train_pickles")
        make_train_split(train_dir, spec)
        from frustum_convnet_tpu_torch.engine import train as trainer

        train_ds, _ = trainer.make_datasets(flagship_cfg(train_dir))
        print(f"[data] synthetic labeled split of {len(train_ds)} train and 256 "
              f"val frustums in {time.time() - t0:.1f}s")
        # 8. one train step, card against CPU
        phase_train_step(spec, device, seeded_model(spec), train_ds)
        # 9. the trainer, through its CLI entry point
        train = phase_trainer(spec, device, work, train_dir)
        # 10. the refine cascade, through the CLIs, from phase 9's weights
        refine = phase_refine(work, train["final"], num_frames=384)
        # 11. SUN-RGBD, through the CLIs
        sunrgbd = phase_sunrgbd(work, num_frames=384)
        # 12. kernel 1 and the forward at the other families' shapes
        families = phase_families(device, work)
        # 13. the precision and BatchNorm variants
        phase_precision_forward(spec, device, model, dataset)
        phase_precision_steps(spec, device, seeded_model(spec), train_ds)
        phase_precision_device(spec, device, seeded_model(spec), train_ds)
        precision = phase_precision_trainer(work, train_dir, served["ap"], model, split)
        phase_precision_profiler(prof_times)
        # 14. the people cascade, through the CLIs
        people = phase_people(work, num_frames=384)
        # 15. the protocol runners at a short size
        runners = phase_runners(work)
        # 16. the data-parallel layer: world 1 over NCCL, 2 ranks over gloo
        data_parallel = phase_data_parallel(spec, work, train_dir, model, split, served,
                                            train, card)
        # 17. the entry points no driver runs: entry(), the dry-run, the device
        # NMS and both profilers
        entry_points = phase_entry_points(device, card)
        # 18. the bench, the per-config sweep and the serving driver's bench
        bench_run = phase_bench(card, work)

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("frustum_convnet_tpu", "jax", "jaxlib", "flax", "optax"))
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    # each path's launches, counted from 0 just before it and read just after;
    # only kernel 1 runs on the drivers' paths
    paths = {"serving": serve_counts, "training": train["counts"]}
    paths.update({k: {"group_depth_point_multi": v}
                  for k, v in {**refine, **sunrgbd, **precision, **people,
                               **runners, **data_parallel,
                               **entry_points["paths"], **bench_run["paths"]}.items()})
    records = []
    for name, launches, numbers in (
            ("group_depth_point_multi", train["counts"]["group_depth_point_multi"],
             {**kernel, "family_shapes": families}),
            ("group_depth_point", prof_launches["group_depth_point"],
             modes["group_depth_point"]),
            ("query_depth_point", prof_launches["query_depth_point"],
             modes["query_depth_point"])):
        per_path = {p: c.get(name, 0) for p, c in paths.items()}
        records.append({"name": name, "route": "cuda",
                        "source": select_cuda.KERNEL_SOURCE,
                        "replaces": select_cuda.REPLACES[name],
                        "launches": launches, **numbers, "library_ms": None,
                        "main_path_launches": sum(per_path.values()),
                        "path_launches": per_path})
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--dp-gradients"]:
        sys.exit(dp_gradients_main())
    if sys.argv[1:2] == ["--entry-points"]:
        sys.exit(entry_points_main())
    if sys.argv[1:2] == ["--bench"]:
        sys.exit(bench_main())
    sys.exit(main())
