"""SUN-RGBD inference/eval driver CLI of the port, on one device or one rank a device:
``python -m frustum_convnet_tpu_torch.engine.test_sunrgbd --cfg <yaml> [--device cuda] [KEY VAL]...``

Counterpart of ``frustum_convnet_tpu/engine/test_sunrgbd.py``: batched
no-grad inference over the SUN-RGBD provider, per-frustum selection
(``nms`` keeps sections with fg prob > 0.5 and falls back to the argmax;
``top`` keeps the argmax), score = 2D detector prob + max size prob, decode
to centroid-anchored boxes (no h/2 bottom shift), drop degenerate sizes,
convert to 8-corner form, optional 3D NMS, then in-process VOC AP at 3D IoU
``cfg.IOU_THRESH`` against ground truth built from the label files.

The serving call is ``run_test``'s (``engine.test.serve_dataset``):
BatchLoader threads prepare batches ahead, G batches go to the device as
one flattened forward (the tail group padded by repeating its last batch,
as the JAX driver does), the selection runs on the device and only the
selected sections come back, and up to ``inflight`` groups queue on the
device while the host post-processes finished ones, a batch at a time.
The model computes in ``TPU.INFER_DTYPE`` and ``TPU.TRUNK_DTYPE``, as in
``engine/test.py``.

Several cards serve as N processes, one a card, as ``engine/test.py`` does
(``--device cuda`` and the environment of ``parallel.mesh``): rank r
streams whole batches r, r + N, ..., one all-gather merges the detection
dicts, and rank 0 alone makes the result directory, writes the log and
runs the VOC AP; the other ranks return the merged detections.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.core import geometry_np as gnp
from frustum_convnet_tpu_torch.core.nms import rotate_nms_3d
from frustum_convnet_tpu_torch.data.provider_sunrgbd import FrustumSunrgbdProvider
from frustum_convnet_tpu_torch.data.sunrgbd.prepare import TYPE_WHITELIST_10
from frustum_convnet_tpu_torch.engine.test import (INIT_SEED, load_state_for_test,
                                                   serve_dataset)
from frustum_convnet_tpu_torch.evaluation.sunrgbd_eval import build_gt_all, eval_det
from frustum_convnet_tpu_torch.models.net import FrustumConvNet
from frustum_convnet_tpu_torch.parallel import mesh
from frustum_convnet_tpu_torch.utils.logger import get_logger

FG_PROB_THRESH = 0.5


def corners_from_params(center, size, heading) -> np.ndarray:
    """Centroid-anchored box -> 8 corners (camera convention, l/w/h order)."""
    return gnp.box3d_corners(np.asarray(center), np.asarray(size), float(heading))


def sunrgbd_rule(out: dict, top: bool) -> tuple:
    """SUN-RGBD's selection on the decoded outputs: the foreground mask fg
    prob > 0.5 (None under 'top') and the packed value, the largest size
    prob."""
    fg_prob = out["cls_probs"][:, :, 1]
    return None if top else fg_prob > FG_PROB_THRESH, out["size_probs"].amax(dim=-1)


def label_format_batch(centers, headings, sizes, rot_angles) -> np.ndarray:
    """(D, 7) float64 = [tx, ty, tz, l, w, h, ry] of D boxes, centroid-anchored
    (no h/2 shift): row for row, bit for bit, what
    ``data.provider_sunrgbd.from_prediction_to_label_format`` gives for the
    same rows (the rotation's cos and sin in the dtype of ``rot_angles``, as
    there)."""
    rot_angles = np.asarray(rot_angles)
    ry = np.asarray(headings) + rot_angles
    c, s = np.cos(-rot_angles), np.sin(-rot_angles)
    centers = np.asarray(centers, dtype=np.float64)
    out = np.empty((len(centers), 7), dtype=np.float64)
    out[:, 0] = c * centers[:, 0] - s * centers[:, 2]
    out[:, 1] = centers[:, 1]
    out[:, 2] = s * centers[:, 0] + c * centers[:, 2]
    out[:, 3:6] = sizes
    out[:, 6] = ry
    return out


def postprocess_packed_sun(packed: np.ndarray, cnt: np.ndarray, batch: dict, dataset,
                           det_results: dict, counts: dict) -> None:
    """Detections of one packed batch (packed (B, S, 8), cnt (B,)), appended
    to ``det_results`` in frustum and section order; score = 2D detector
    prob + max size prob, boxes with a side under 1 cm dropped. Every real
    frustum gets its image and class entry, kept boxes or not."""
    real = int(batch["_real"])
    cnt = cnt[:real]
    idxs = [int(i) for i in batch["_indices"][:real]]
    ids, types, box2ds = dataset.data["id"], dataset.data["type"], dataset.data["box2d"]
    per_cls = [det_results.setdefault(int(ids[gi]), {}).setdefault(types[gi], [])
               for gi in idxs]
    slot = np.arange(packed.shape[1])
    det_b, det_s = np.nonzero(slot[None, :] < cnt[:, None])
    rows = packed[det_b, det_s]  # (D, 8)
    rgb_probs = batch.get("rgb_prob", np.ones(len(batch["_indices"]), np.float32)).reshape(-1)
    boxes = label_format_batch(rows[:, 0:3], rows[:, 3], rows[:, 4:7],
                               batch["rot_angle"].reshape(-1)[det_b])
    scores = rgb_probs[det_b] + rows[:, 7]
    degenerate = (rows[:, 4:7] < 0.01).any(axis=1)
    counts["sections"] += len(det_b)
    counts["degenerate"] += int(degenerate.sum())
    counts["detections"] += int((~degenerate).sum())
    for d in np.nonzero(~degenerate)[0]:
        b2 = box2ds[idxs[det_b[d]]]
        per_cls[det_b[d]].append([b2[0], b2[1], b2[2], b2[3], *boxes[d].tolist(),
                                  float(scores[d])])


def run_test_sunrgbd(model, spec, dataset, batch_size: int, method: str, logger,
                     num_workers: int = 4, inflight: int = 2, group: int = 8,
                     points_dtype: torch.dtype = torch.float16):
    """Stream ``dataset`` through ``model`` on its device in groups of
    ``group`` batches (``engine.test.serve_dataset``, ``run_test``'s serving
    call), with SUN-RGBD's selection (``sunrgbd_rule``) on the device and
    its postprocess (``postprocess_packed_sun``) on the host; accumulate
    detections.

    Returns (det_results, stats): {img: {class: [[x1, y1, x2, y2, tx, ty, tz,
    l, w, h, ry, score]]}} and {"frustums", "seconds", "frustums_per_s",
    "sections", "detections", "degenerate", "fetch_waited", "spans"} as
    ``serve_dataset`` counts them: ``sections`` the selected sections,
    ``detections`` those kept and ``degenerate`` those dropped for a size
    under 1 cm."""
    return serve_dataset(model, spec, dataset, batch_size, method, logger, sunrgbd_rule,
                         postprocess_packed_sun,
                         {"sections": 0, "detections": 0, "degenerate": 0},
                         num_workers, group, inflight, points_dtype)


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
