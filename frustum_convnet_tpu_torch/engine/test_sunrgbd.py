"""SUN-RGBD inference/eval driver CLI of the port, on one device or one rank a device:
``python -m frustum_convnet_tpu_torch.engine.test_sunrgbd --cfg <yaml> [--device cuda] [KEY VAL]...``

Counterpart of ``frustum_convnet_tpu/engine/test_sunrgbd.py``: batched
no-grad inference over the SUN-RGBD provider, per-frustum selection
(``nms`` keeps sections with fg prob > 0.5 and falls back to the argmax;
``top`` keeps the argmax), score = 2D detector prob + max size prob, decode
to centroid-anchored boxes (no h/2 bottom shift), drop degenerate sizes,
convert to 8-corner form, optional 3D NMS, then in-process VOC AP at 3D IoU
``cfg.IOU_THRESH`` against ground truth built from the label files.

The pipelining is the JAX driver's: BatchLoader threads prepare batches
ahead, G batches go to the device as one flattened forward (the tail group
padded by repeating its last batch), and up to ``inflight`` groups queue on
the device while the host post-processes finished ones. The model computes
in ``TPU.INFER_DTYPE`` and ``TPU.TRUNK_DTYPE``, as in ``engine/test.py``.

Several cards serve as N processes, one a card, as ``engine/test.py`` does
(``--device cuda`` and the environment of ``parallel.mesh``): rank r
streams whole batches r, r + N, ..., one all-gather merges the detection
dicts, and rank 0 alone makes the result directory, writes the log and
runs the VOC AP; the other ranks return the merged detections.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import deque

import numpy as np
import torch

from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.core import geometry_np as gnp
from frustum_convnet_tpu_torch.core.nms import rotate_nms_3d
from frustum_convnet_tpu_torch.data.provider_sunrgbd import (
    FrustumSunrgbdProvider, from_prediction_to_label_format)
from frustum_convnet_tpu_torch.data.sunrgbd.prepare import TYPE_WHITELIST_10
from frustum_convnet_tpu_torch.engine.loader import BatchLoader
from frustum_convnet_tpu_torch.engine.test import (INIT_SEED, load_state_for_test,
                                                   strict_fp32)
from frustum_convnet_tpu_torch.evaluation.sunrgbd_eval import build_gt_all, eval_det
from frustum_convnet_tpu_torch.models.det import decode_outputs
from frustum_convnet_tpu_torch.models.net import FrustumConvNet
from frustum_convnet_tpu_torch.parallel import mesh
from frustum_convnet_tpu_torch.utils.logger import get_logger

FG_PROB_THRESH = 0.5


def corners_from_params(center, size, heading) -> np.ndarray:
    """Centroid-anchored box -> 8 corners (camera convention, l/w/h order)."""
    return gnp.box3d_corners(np.asarray(center), np.asarray(size), float(heading))


def build_infer_group_flat_fn(model, spec):
    """G stacked batches -> one flattened (G*B) forward, full decode back.

    The SUN-RGBD postprocess scores with the full per-section size
    probabilities (score = rgb prob + max size prob), so the outputs come
    back undecimated, reshaped to (G, B, ...)."""

    @torch.inference_mode()
    def infer_group(pts_g, one_hot_g, refs_g):
        g, b = pts_g.shape[:2]

        def flat(x):
            return x.reshape((g * b,) + tuple(x.shape[2:]))

        refs = [flat(r) for r in refs_g]
        # pts may arrive in the reduced upload dtype: kernel 1 takes float32
        cls_logits, reg = model(flat(pts_g).float(), flat(one_hot_g), refs)
        out = decode_outputs(spec, cls_logits, reg, refs[1])
        return {k: v.reshape((g, b) + tuple(v.shape[1:])) for k, v in out.items()}

    return infer_group


def select_sections(cls_probs: np.ndarray, method: str) -> np.ndarray:
    """One frustum's selected sections from cls_probs (L, 2): 'nms' keeps
    every section with fg prob > 0.5 (the argmax when none is), 'top' the
    argmax."""
    if method == "nms":
        fg_idx = np.nonzero(cls_probs[:, 1] > FG_PROB_THRESH)[0]
        if fg_idx.size:
            return fg_idx
    return np.array([np.argmax(cls_probs[:, 1])])


def run_test_sunrgbd(model, spec, dataset, batch_size: int, method: str, logger,
                     num_workers: int = 4, inflight: int = 2, group: int = 8,
                     points_dtype: torch.dtype = torch.float16):
    """Stream ``dataset`` through ``model`` on its device; accumulate detections.

    Under a process group of N > 1 ranks this rank streams its batch shard
    and every rank returns the merged detections; the stats are this rank's.

    Returns (det_results, stats): {img: {class: [[x1, y1, x2, y2, tx, ty, tz,
    l, w, h, ry, score]]}} and {"frustums", "seconds", "frustums_per_s",
    "sections", "detections", "degenerate"}:
    ``frustums`` counts the real frustums streamed here, ``sections`` the
    selected sections, ``detections`` those kept and ``degenerate`` those
    dropped for a size under 1 cm."""
    strict_fp32()
    model.eval()
    device = next(model.parameters()).device
    group = max(int(group), 1)
    infer_group = build_infer_group_flat_fn(model, spec)
    pc, pi = mesh.process_count(), mesh.process_index()
    loader = BatchLoader(dataset, batch_size, spec.num_scales, shuffle=False,
                         drop_last=False, pad_last=True, seed=0,
                         num_workers=num_workers,
                         batch_shard=(pi, pc) if pc > 1 else None)
    num_batches = len(range(pi, len(loader), pc))
    det_results: dict = {}
    counts = {"sections": 0, "detections": 0, "degenerate": 0}

    def upload(x, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(x))
        return (t if dtype is None else t.to(dtype)).to(device)

    def dispatch(batches):
        """<= group host batches -> one stacked forward (the tail pads by
        repeating its last batch)."""
        if len(batches) < group:
            batches = batches + [batches[-1]] * (group - len(batches))
        pts = upload(np.stack([b["point_cloud"] for b in batches]), points_dtype)
        one_hot = upload(np.stack([b["one_hot"] for b in batches]))
        refs = [upload(np.stack([b["refs"][i] for b in batches]))
                for i in range(spec.num_scales)]
        return infer_group(pts, one_hot, refs)

    def process_one(out, batch):
        idxs = [int(i) for i in batch["_indices"][:int(batch["_real"])]]
        rgb_probs = batch.get("rgb_prob", np.ones(batch_size, np.float32)).reshape(-1)
        rot_angles = batch["rot_angle"].reshape(-1)
        for k, gi in enumerate(idxs):
            fg_idx = select_sections(out["cls_probs"][k], method)
            scores = rgb_probs[k] + out["size_probs"][k][fg_idx].max(axis=1)
            data_idx = int(dataset.data["id"][gi])
            class_type = dataset.data["type"][gi]
            box2d = np.asarray(dataset.data["box2d"][gi])
            per_cls = det_results.setdefault(data_idx, {}).setdefault(class_type, [])
            counts["sections"] += fg_idx.size
            for m, s in zip(fg_idx, scores):
                tx, ty, tz, l, w, h, ry = from_prediction_to_label_format(
                    out["centers"][k][m], out["headings"][k][m],
                    out["sizes"][k][m], rot_angles[k])
                if h < 0.01 or w < 0.01 or l < 0.01:
                    counts["degenerate"] += 1
                    continue
                counts["detections"] += 1
                per_cls.append([box2d[0], box2d[1], box2d[2], box2d[3],
                                tx, ty, tz, l, w, h, ry, float(s)])

    def process(out_dev, batches):
        out = {k: v.cpu().numpy() for k, v in out_dev.items()}  # waits for it
        for j, batch in enumerate(batches):  # padded replicas are not listed
            process_one({k: v[j] for k, v in out.items()}, batch)

    t_start = time.time()
    pending: deque = deque()
    acc: list = []
    n = 0
    for bi, batch in enumerate(loader.epoch(0)):
        n += int(batch["_real"])
        acc.append(batch)
        if len(acc) == group:
            pending.append((dispatch(acc), acc))
            acc = []
            while len(pending) >= max(inflight, 1):
                process(*pending.popleft())
        if (bi + 1) % (20 * group) == 0:
            rate = (bi + 1) * batch_size / (time.time() - t_start)
            logger.info(f"batch {bi + 1}/{num_batches}  {rate:.0f} frustums/s")
    if acc:
        pending.append((dispatch(acc), acc))
    while pending:
        process(*pending.popleft())
    elapsed = time.time() - t_start
    where = f" on rank {pi} of {pc}" if pc > 1 else ""
    logger.info(f"streamed {n} frustums{where} in {elapsed:.2f}s = "
                f"{n / elapsed:.0f} frustums/s end-to-end ({counts['sections']} "
                f"selected sections, {counts['detections']} detections, "
                f"{counts['degenerate']} degenerate)")
    stats = {"frustums": n, "seconds": elapsed, "frustums_per_s": n / elapsed,
             **counts}
    if pc > 1:  # one collective merges the ranks' detection dicts
        det_results = mesh.allgather_detections(det_results)
    return det_results, stats


def to_corner_results(det_results, nms_threshold=None):
    """{img: {cls: [entry]}} -> {cls: {img: [(corners, score)]}} (+ 3D NMS)."""
    all_results: dict = {}
    for idx, per_class in det_results.items():
        for cls, dets in per_class.items():
            arr = np.asarray(dets, dtype=np.float64)
            if nms_threshold is not None and len(arr) > 1:
                # (tx,ty,tz,l,w,h,ry,score): already center-anchored
                keep = rotate_nms_3d(arr[:, 4:], nms_threshold)
                arr = arr[keep]
            for det in arr:
                corners = corners_from_params(det[4:7], det[7:10], det[10])
                all_results.setdefault(cls, {}).setdefault(idx, []).append(
                    (corners, float(det[11])))
    return all_results


def main(argv=None):
    """Run the driver; returns {"ap": {class: AP} or None, "stats":
    run_test_sunrgbd's stats, "result_dir" (None off rank 0), "det_results":
    the detections of every rank}."""
    parser = argparse.ArgumentParser(description="Test FrustumConvNet on SUN-RGBD (PyTorch)")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cuda:N or cpu)")
    parser.add_argument("--sunrgbd_dir", default="sunrgbd/mysunrgbd")
    parser.add_argument("--val_idx", default="sunrgbd/image_sets/val.txt")
    parser.add_argument("--no_eval", action="store_true")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)

    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(args.cfg_file, cfg)
    if args.opts:
        configs.merge_cfg_from_list(args.opts, cfg)
    configs.assert_and_infer_cfg(cfg)
    dtype = configs.get_compute_dtype(cfg, train=False)
    trunk_dtype = configs.get_trunk_dtype(cfg)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible")
    # the process group before anything touches the device (env-gated)
    with mesh.distributed(device) as device:
        return _serve(cfg, args, device, dtype, trunk_dtype)


def _serve(cfg, args, device, dtype, trunk_dtype) -> dict:
    mesh.make_mesh(cfg.TPU.MESH_SHAPE, cfg.TPU.MESH_AXES)
    chief = mesh.is_chief()
    result_dir = os.path.join(cfg.OUTPUT_DIR, cfg.SAVE_SUB_DIR, "result")
    if chief:  # files belong to rank 0; the other ranks log to the console
        os.makedirs(result_dir, exist_ok=True)
    logger = get_logger(os.path.join(result_dir, "test.log") if chief else None)

    spec = configs.get_model_spec(cfg)
    model = FrustumConvNet(spec, dtype=dtype, trunk_dtype=trunk_dtype)
    model.reset_parameters(torch.Generator().manual_seed(INIT_SEED))
    model.to(device).eval()
    dataset = FrustumSunrgbdProvider(
        cfg, cfg.TEST.DATASET, one_hot=True,
        from_rgb_detection=cfg.FROM_RGB_DET,
        overwritten_data_path=cfg.OVER_WRITE_TEST_FILE)
    logger.info(f"test frustums: {len(dataset)} on {device}")

    load_state_for_test(model, cfg, logger)
    det_results, stats = run_test_sunrgbd(
        model, spec, dataset, cfg.TEST.BATCH_SIZE, cfg.TEST.METHOD, logger,
        num_workers=cfg.NUM_WORKERS, inflight=cfg.TPU.INFER_INFLIGHT,
        group=cfg.TPU.INFER_GROUP, points_dtype=configs.get_points_upload_dtype(cfg))
    if not chief:  # run_test_sunrgbd merged every rank's detections
        return {"ap": None, "stats": stats, "result_dir": None,
                "det_results": det_results}
    nms_thresh = cfg.TEST.THRESH if cfg.TEST.METHOD == "nms" else None
    pred_all = to_corner_results(det_results, nms_thresh)

    aps = None
    if not args.no_eval:
        with open(args.val_idx) as f:
            idx_list = [int(line) for line in f if line.strip()]
        gt_all = build_gt_all(args.sunrgbd_dir, idx_list, TYPE_WHITELIST_10)
        _recs, _precs, aps = eval_det(pred_all, gt_all, ovthresh=cfg.IOU_THRESH,
                                      result_dir=result_dir)
        logger.info(f"AP results: {aps}")
    return {"ap": aps, "stats": stats, "result_dir": result_dir,
            "det_results": det_results}


if __name__ == "__main__":
    main()
