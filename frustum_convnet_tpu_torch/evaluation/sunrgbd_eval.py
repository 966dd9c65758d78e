"""SUN-RGBD VOC-style AP evaluation (3D IoU, default threshold 0.25).

Fresh implementation of the protocol in
reference `train/sunrgbd_eval/eval_det.py:41-231`:

* per class, detections sorted by confidence, greedily matched against
  unmatched GT boxes by max 3D IoU; TP iff IoU > ovthresh;
* AP = area under the interpolated PR curve (``voc_ap``; optional VOC07
  11-point variant);
* box representation is 8 corners in the upright camera frame.

The reference reads its ground truth from MATLAB toolbox dumps
(`compare_matlab_python_eval.py:25-79`) to pin Python AP to the MATLAB
evaluator; here :func:`build_gt_all` constructs the equivalent structure
directly from SUN-RGBD label files.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from frustum_convnet_tpu_torch.core.iou_np import rotated_iou_3d_np


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def get_iou_3d(corners1: np.ndarray, corners2: np.ndarray) -> float:
    return rotated_iou_3d_np(corners1, corners2)[1]


def eval_det_cls(pred: Dict[int, List[Tuple[np.ndarray, float]]],
                 gt: Dict[int, List[np.ndarray]],
                 ovthresh: float = 0.25, use_07_metric: bool = False):
    """One class: pred {img: [(corners, score)]}, gt {img: [corners]}."""
    class_recs = {}
    npos = 0
    for img_id, boxes in gt.items():
        class_recs[img_id] = {"bbox": list(boxes), "det": [False] * len(boxes)}
        npos += len(boxes)
    for img_id in pred:
        class_recs.setdefault(img_id, {"bbox": [], "det": []})

    image_ids, confidence, BB = [], [], []
    for img_id, dets in pred.items():
        for box, score in dets:
            image_ids.append(img_id)
            confidence.append(score)
            BB.append(box)
    nd = len(image_ids)
    if nd == 0 or npos == 0:
        return np.zeros(0), np.zeros(0), 0.0

    order = np.argsort(-np.asarray(confidence))
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for rank, d in enumerate(order):
        rec_entry = class_recs[image_ids[d]]
        ovmax, jmax = -np.inf, -1
        for j, gt_box in enumerate(rec_entry["bbox"]):
            iou = get_iou_3d(np.asarray(BB[d], dtype=float), np.asarray(gt_box, dtype=float))
            if iou > ovmax:
                ovmax, jmax = iou, j
        if ovmax > ovthresh and not rec_entry["det"][jmax]:
            tp[rank] = 1.0
            rec_entry["det"][jmax] = True
        else:
            fp[rank] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def eval_det(pred_all: Dict[str, Dict[int, List[Tuple[np.ndarray, float]]]],
             gt_all: Dict[str, Dict[int, List[np.ndarray]]],
             ovthresh: float = 0.25, use_07_metric: bool = False,
             result_dir: str | None = None):
    """All classes: returns ({cls: rec}, {cls: prec}, {cls: ap})."""
    recs, precs, aps = {}, {}, {}
    for cls in sorted(set(pred_all) | set(gt_all)):
        recs[cls], precs[cls], aps[cls] = eval_det_cls(
            pred_all.get(cls, {}), gt_all.get(cls, {}), ovthresh, use_07_metric)
        print(f"{cls} AP: {aps[cls] * 100:.2f}")
    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    print(f"mAP: {mean_ap * 100:.2f}")
    if result_dir:
        import json
        import os
        with open(os.path.join(result_dir, "sunrgbd_ap.json"), "w") as f:
            json.dump({"ap": {k: float(v) for k, v in aps.items()},
                       "mAP": mean_ap}, f, indent=2)
        dump_pr_curves(recs, precs, result_dir)
    return recs, precs, aps


def dump_pr_curves(recs, precs, result_dir: str) -> None:
    """Per-class PR-curve PNGs under ``result_dir/ap_curves/`` (reference
    behavior, `train/sunrgbd_eval/eval_det.py:210-227`). Silently skipped
    when matplotlib is unavailable."""
    import os

    from frustum_convnet_tpu_torch.evaluation.plots import save_pr_plot

    for cls in sorted(recs):
        save_pr_plot(os.path.join(result_dir, "ap_curves", f"{cls}.png"),
                     cls, [precs[cls]], recalls=[recs[cls]])


def build_gt_all(sunrgbd_dir: str, idx_list, type_whitelist) -> Dict[str, Dict[int, List[np.ndarray]]]:
    """{classname: {img_id: [8-corner boxes in upright camera]}} from labels."""
    from frustum_convnet_tpu_torch.data.sunrgbd.calib import compute_box3d_upright_depth
    from frustum_convnet_tpu_torch.data.sunrgbd.object import SunrgbdObjectDataset

    dataset = SunrgbdObjectDataset(sunrgbd_dir, "training")
    gt_all: Dict[str, Dict[int, List[np.ndarray]]] = {}
    for idx in idx_list:
        calib = dataset.get_calibration(idx)
        for obj in dataset.get_label_objects(idx):
            if obj.classname not in type_whitelist:
                continue
            corners = calib.upright_depth_to_upright_camera(
                compute_box3d_upright_depth(obj))
            gt_all.setdefault(obj.classname, {}).setdefault(idx, []).append(corners)
    return gt_all


def load_matlab_gt_cls(gt_boxes_dir: str, classname: str) -> Dict[int, List[np.ndarray]]:
    """Load one class's GT boxes from the reference's MATLAB eval dumps.

    The reference ships the MATLAB evaluator's ground truth as
    ``<cls>_gt_boxes.dat`` (rows: 8 xy floats = 4 BEV vertices in upright
    depth coords, then zmin, zmax) plus ``<cls>_gt_imgids.txt``, and pins
    its Python VOC-AP evaluator to the MATLAB one through them
    (reference `train/sunrgbd_eval/compare_matlab_python_eval.py:25-79`).
    Conversion: fix vertex winding to counter-clockwise, extrude [zmin,
    zmax], flip depth axes to camera (X,-Z,Y swap), then swap the top/bottom
    corner quads — yielding the 8-corner upright-camera boxes our evaluator
    consumes.
    """
    import os

    boxes = np.loadtxt(os.path.join(gt_boxes_dir, f"{classname}_gt_boxes.dat"))
    imgids = np.loadtxt(os.path.join(gt_boxes_dir, f"{classname}_gt_imgids.txt"))
    boxes = np.atleast_2d(boxes)
    imgids = np.atleast_1d(imgids)

    gt: Dict[int, List[np.ndarray]] = {}
    for row, imgid in zip(boxes, imgids):
        xy = row[:8].reshape(4, 2)
        # MATLAB dumps mix windings; normalize to negative signed area
        # (the reference keeps the order when its shoelace test
        # `is_clockwise` is true, i.e. 2*signed_area < 0, and reverses
        # otherwise — `compare_matlab_python_eval.py:33-40`)
        area2 = float(np.cross(xy[1] - xy[0], xy[2] - xy[0])
                      + np.cross(xy[2] - xy[0], xy[3] - xy[0]))
        if area2 > 0:
            xy = xy[::-1]
        zmin, zmax = row[8], row[9]
        depth = np.zeros((8, 3))
        depth[0:4, 0:2] = xy
        depth[4:8, 0:2] = xy
        depth[0:4, 2] = zmax
        depth[4:8, 2] = zmin
        # upright depth (X right, Y fwd, Z up) -> camera (X right, Y down,
        # Z fwd), then put the y=low quad first (camera-frame convention)
        cam = depth[:, [0, 2, 1]].copy()
        cam[:, 1] *= -1
        flipped = np.concatenate([cam[4:8], cam[0:4]], axis=0)
        gt.setdefault(int(imgid), []).append(flipped)
    return gt
