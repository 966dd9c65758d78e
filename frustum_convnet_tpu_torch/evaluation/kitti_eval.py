"""Official-protocol KITTI AP evaluator (bbox / BEV / 3D / AOS), in numpy.

Fresh implementation of the evaluation protocol of the KITTI object devkit
as shipped by the reference
(reference `train/kitti_eval/evaluate_object_3d_offline.cpp`):

* 41 recall-discretized sample points (`:59,348-381`), AP reported as the
  mean of every 4th point (11-point average) x 100 (`:706-720`);
* difficulty gates MIN_HEIGHT {40, 25, 25} px, MAX_OCCLUSION {0, 1, 2},
  MAX_TRUNCATION {0.15, 0.3, 0.5} (`:43-45`);
* min overlap 0.7 for Car, 0.5 for Pedestrian/Cyclist (`:56`);
* neighboring-class ignores (Van<->Car, Person_sitting<->Pedestrian,
  `:396-403`) and DontCare regions (`:431-434`);
* three metrics: image-2D IoU, BEV rotated-polygon IoU in the (x, z) plane,
  and 3D polygon x height IoU (`:229-346`); AOS orientation similarity.

The greedy TP assignment, two-pass threshold/PR computation, and
right-to-left precision maximization follow the devkit algorithm exactly, so
AP numbers are comparable with the official scores. The rotated IoU uses
this repo's polygon-clip oracle instead of boost::geometry.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List

import numpy as np

from frustum_convnet_tpu_torch.core import geometry_np as gnp
from frustum_convnet_tpu_torch.core import iou_np

N_SAMPLE_PTS = 41
MIN_HEIGHT = [40.0, 25.0, 25.0]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
CLASS_NAMES = ["car", "pedestrian", "cyclist"]
MIN_OVERLAP = {"car": 0.7, "pedestrian": 0.5, "cyclist": 0.5}
NEIGHBOR_CLASSES = {"car": ["van"], "pedestrian": ["person_sitting"]}

NO_DETECTION = -10_000_000.0


@dataclasses.dataclass
class TBox:
    type: str
    x1: float
    y1: float
    x2: float
    y2: float
    alpha: float = -10.0
    # 3D (rect frame, bottom-anchored t as in KITTI labels)
    h: float = -1.0
    w: float = -1.0
    l: float = -1.0
    t: tuple = (-1000.0, -1000.0, -1000.0)
    ry: float = -10.0
    score: float = 0.0
    truncation: float = -1.0
    occlusion: int = -1


def parse_label_file(path: str, is_det: bool) -> List[TBox]:
    boxes = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            vals = [float(x) for x in p[1:]]
            b = TBox(
                type=p[0].lower(),
                truncation=vals[0], occlusion=int(vals[1]), alpha=vals[2],
                x1=vals[3], y1=vals[4], x2=vals[5], y2=vals[6],
                h=vals[7], w=vals[8], l=vals[9],
                t=(vals[10], vals[11], vals[12]), ry=vals[13],
                score=vals[14] if (is_det and len(vals) > 14) else 0.0,
            )
            boxes.append(b)
    return boxes


# ---------------------------------------------------------------------------
# overlaps
# ---------------------------------------------------------------------------

def _image_iou(d: TBox, g: TBox, criterion: int = -1) -> float:
    ix = max(0.0, min(d.x2, g.x2) - max(d.x1, g.x1))
    iy = max(0.0, min(d.y2, g.y2) - max(d.y1, g.y1))
    inter = ix * iy
    a_d = (d.x2 - d.x1) * (d.y2 - d.y1)
    a_g = (g.x2 - g.x1) * (g.y2 - g.y1)
    if criterion == -1:
        denom = a_d + a_g - inter
    elif criterion == 0:  # intersection over det area (DontCare test)
        denom = a_d
    else:
        denom = a_g
    return inter / denom if denom > 0 else 0.0


def _box_corners(b: TBox) -> np.ndarray:
    center = np.array([b.t[0], b.t[1] - b.h / 2.0, b.t[2]])
    return gnp.box3d_corners(center, (b.l, b.w, b.h), b.ry)


def _bev_iou(d: TBox, g: TBox) -> float:
    return iou_np.rotated_iou_bev_np(
        iou_np.box_bev_polygon(_box_corners(d)), iou_np.box_bev_polygon(_box_corners(g))
    )


def _3d_iou(d: TBox, g: TBox) -> float:
    return iou_np.rotated_iou_3d_np(_box_corners(d), _box_corners(g))[1]


def _overlap(d: TBox, g: TBox, metric: int) -> float:
    if metric == 0:
        return _image_iou(d, g)
    if metric == 1:
        return _bev_iou(d, g)
    return _3d_iou(d, g)


# ---------------------------------------------------------------------------
# devkit algorithm
# ---------------------------------------------------------------------------

def clean_data(gts: List[TBox], dets: List[TBox], cls: str, difficulty: int,
               strict_height: bool = False):
    """Classify gts/dets into evaluated / ignored / excluded (devkit cleanData).

    ``strict_height`` selects the KITTI-*server* variant's gt gate
    ``height <= MIN_HEIGHT`` (`evaluate_object.cpp:413`) over the offline
    binary's ``height < MIN_HEIGHT`` (`evaluate_object_3d_offline.cpp:412`).
    The detection gate is ``<`` in both variants.
    """
    ignored_gt, dontcare = [], []
    n_gt = 0
    for g in gts:
        if g.type == cls:
            valid_class = 1
        elif g.type in NEIGHBOR_CLASSES.get(cls, []):
            valid_class = 0
        else:
            valid_class = -1
        height = g.y2 - g.y1
        too_small = (height <= MIN_HEIGHT[difficulty] if strict_height
                     else height < MIN_HEIGHT[difficulty])
        ignore = (
            g.occlusion > MAX_OCCLUSION[difficulty]
            or g.truncation > MAX_TRUNCATION[difficulty]
            or too_small
        )
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            n_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if g.type == "dontcare":
            dontcare.append(g)

    ignored_det = []
    for d in dets:
        if d.type != cls:
            ignored_det.append(-1)
        elif (d.y2 - d.y1) < MIN_HEIGHT[difficulty]:
            ignored_det.append(1)
        else:
            ignored_det.append(0)
    return ignored_gt, dontcare, ignored_det, n_gt


def pairwise_overlaps(gts, dets, dontcare, metric: int):
    """(gt x det) rotated overlaps + (dontcare x det) image IoUs for one
    image — threshold-independent, so eval_class computes them once per
    (image, metric) and reuses them across all 41 recall thresholds (the
    C++ devkit re-clips per threshold; pure-Python clipping cannot afford
    the 41x redundancy on real KITTI val)."""
    ov = np.array([[_overlap(d, g, metric) for d in dets] for g in gts],
                  dtype=np.float64).reshape(len(gts), len(dets))
    dc = np.array([[_image_iou(d, c, criterion=0) for d in dets]
                   for c in dontcare],
                  dtype=np.float64).reshape(len(dontcare), len(dets))
    return ov, dc


def compute_statistics(cls: str, gts, dets, dontcare, ignored_gt, ignored_det,
                       compute_fp: bool, metric: int, min_overlap: float,
                       thresh: float = 0.0, compute_aos: bool = False,
                       overlaps=None):
    """One image's tp/fp/fn (+ scores / orientation sims). Devkit semantics."""
    if overlaps is None:
        overlaps = pairwise_overlaps(gts, dets, dontcare, metric)
    gt_ov, dc_ov = overlaps
    tp = fp = fn = 0
    scores: List[float] = []
    deltas: List[float] = []
    assigned = [False] * len(dets)
    ignored_threshold = [
        compute_fp and d.score < thresh for d in dets
    ]

    for i, g in enumerate(gts):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False

        for j, d in enumerate(dets):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = gt_ov[i, j]
            if not compute_fp:
                if overlap > min_overlap and d.score > valid_detection:
                    det_idx = j
                    valid_detection = d.score
            else:
                if (overlap > min_overlap
                        and (overlap > max_overlap or assigned_ignored_det)
                        and ignored_det[j] == 0):
                    max_overlap = overlap
                    det_idx = j
                    valid_detection = 1.0
                    assigned_ignored_det = False
                elif (overlap > min_overlap
                        and valid_detection == NO_DETECTION
                        and ignored_det[j] == 1):
                    det_idx = j
                    valid_detection = 1.0
                    assigned_ignored_det = True

        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
                ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            scores.append(dets[det_idx].score)
            if compute_aos:
                deltas.append(g.alpha - dets[det_idx].alpha)
            assigned[det_idx] = True

    if compute_fp:
        for j, d in enumerate(dets):
            if not (assigned[j] or ignored_det[j] in (-1, 1) or ignored_threshold[j]):
                fp += 1
        # subtract detections landing on DontCare areas (image-space test)
        nstuff = 0
        for ci in range(len(dontcare)):
            for j, d in enumerate(dets):
                if assigned[j] or ignored_det[j] in (-1, 1) or ignored_threshold[j]:
                    continue
                if dc_ov[ci, j] > min_overlap:
                    assigned[j] = True
                    nstuff += 1
        fp -= nstuff

    similarity = -1.0
    if compute_aos and compute_fp:
        if tp + fp > 0:
            sim = sum((1.0 + np.cos(dl)) / 2.0 for dl in deltas)
            similarity = sim  # normalized later by tp+fp accumulation
        else:
            similarity = 0.0
    return tp, fp, fn, scores, similarity


def get_thresholds(scores: np.ndarray, n_gt: int) -> np.ndarray:
    """Recall-discretized score thresholds (devkit getThresholds)."""
    scores = np.sort(np.asarray(scores))[::-1]
    thresholds = []
    current_recall = 0.0
    for i, s in enumerate(scores):
        l_recall = (i + 1) / n_gt
        r_recall = (i + 2) / n_gt if i < len(scores) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) and i < len(scores) - 1:
            continue
        thresholds.append(s)
        current_recall += 1.0 / (N_SAMPLE_PTS - 1)
    return np.asarray(thresholds)


def eval_class(gt_by_img: Dict[int, List[TBox]], det_by_img: Dict[int, List[TBox]],
               cls: str, difficulty: int, metric: int,
               compute_aos: bool = False, ov_cache: Dict | None = None,
               strict_height: bool = False):
    """Precision (and AOS similarity) curve over 41 recall points.

    ``ov_cache`` (keyed by image id) shares the pairwise overlap matrices
    across calls — they depend only on the geometry + metric, not on the
    class or difficulty, so evaluate() passes one cache per metric and the
    polygon clipping runs once per (image, metric) total.
    """
    min_overlap = MIN_OVERLAP[cls]
    img_ids = sorted(gt_by_img.keys())
    if ov_cache is None:
        ov_cache = {}

    cleaned = {}
    cached_ov = {}
    all_scores: List[float] = []
    total_gt = 0
    for idx in img_ids:
        gts = gt_by_img[idx]
        dets = det_by_img.get(idx, [])
        ignored_gt, dontcare, ignored_det, n_gt = clean_data(
            gts, dets, cls, difficulty, strict_height=strict_height)
        cleaned[idx] = (ignored_gt, dontcare, ignored_det)
        # overlaps are threshold/class/difficulty-independent: computed once
        # per (image, metric) and reused everywhere
        if idx not in ov_cache:
            ov_cache[idx] = pairwise_overlaps(gts, dets, dontcare, metric)
        cached_ov[idx] = ov_cache[idx]
        total_gt += n_gt
        _, _, _, scores, _ = compute_statistics(
            cls, gts, dets, dontcare, ignored_gt, ignored_det,
            compute_fp=False, metric=metric, min_overlap=min_overlap,
            overlaps=cached_ov[idx])
        all_scores.extend(scores)

    precision = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    if total_gt == 0 or not all_scores:
        return precision, aos

    thresholds = get_thresholds(np.asarray(all_scores), total_gt)
    tps = np.zeros(len(thresholds))
    fps = np.zeros(len(thresholds))
    fns = np.zeros(len(thresholds))
    sims = np.zeros(len(thresholds))
    for idx in img_ids:
        gts = gt_by_img[idx]
        dets = det_by_img.get(idx, [])
        ignored_gt, dontcare, ignored_det = cleaned[idx]
        for ti, t in enumerate(thresholds):
            tp, fp, fn, _, sim = compute_statistics(
                cls, gts, dets, dontcare, ignored_gt, ignored_det,
                compute_fp=True, metric=metric, min_overlap=min_overlap,
                thresh=t, compute_aos=compute_aos, overlaps=cached_ov[idx])
            tps[ti] += tp
            fps[ti] += fp
            fns[ti] += fn
            if compute_aos and sim >= 0:
                sims[ti] += sim

    for ti in range(len(thresholds)):
        denom = tps[ti] + fps[ti]
        precision[ti] = tps[ti] / denom if denom > 0 else 0.0
        if compute_aos:
            aos[ti] = sims[ti] / denom if denom > 0 else 0.0

    # right-to-left max (monotone non-increasing envelope)
    for ti in range(N_SAMPLE_PTS):
        precision[ti] = precision[ti:].max()
        if compute_aos:
            aos[ti] = aos[ti:].max()
    return precision, aos


def ap_from_curve(precision: np.ndarray) -> float:
    """11-point AP x 100 (mean of every 4th of the 41 points, ref :706-720)."""
    return float(np.mean(precision[0::4]) * 100.0)


def _det_metric_available(dets_by_img: Dict[int, List[TBox]], cls: str,
                          metric: int) -> bool:
    """Server-variant per-class metric gating (`evaluate_object.cpp:144-151`):
    BEV needs t1/t3 present and w,l > 0; 3D additionally t2 and h > 0."""
    for dets in dets_by_img.values():
        for d in dets:
            if d.type != cls:
                continue
            has_ground = (d.t[0] != -1000 and d.t[2] != -1000
                          and d.w > 0 and d.l > 0)
            if metric == 1 and has_ground:
                return True
            if metric == 2 and has_ground and d.t[1] != -1000 and d.h > 0:
                return True
    return False


def evaluate(gt_dir: str, result_dir: str, classes=("car",),
             metrics=(0, 1, 2), compute_aos: bool = True,
             protocol: str = "offline") -> Dict[str, Dict]:
    """Evaluate ``result_dir/data/*.txt`` against ``gt_dir/*.txt``.

    Returns {class: {metric_name: [AP_easy, AP_mod, AP_hard]}} and writes
    reference-style ``stats_<cls>_detection*.txt`` precision curves.

    ``protocol`` selects between the two devkit binaries the reference ships:

    * ``"offline"`` (`evaluate_object_3d_offline.cpp`, the default): the
      evaluated image set is discovered from the result dir; gt gate
      ``height < MIN_HEIGHT``.
    * ``"server"`` (`evaluate_object.cpp`, the KITTI submission server):
      every gt image must have a result file (missing => error, mirroring
      the server abort), gt gate ``height <= MIN_HEIGHT``, and BEV/3D
      metrics are skipped per class unless some detection of that class
      carries the full 3D fields (`:144-151`).
    """
    assert protocol in ("offline", "server"), protocol
    strict_height = protocol == "server"
    data_dir = os.path.join(result_dir, "data")

    gt_by_img, det_by_img = {}, {}
    if protocol == "server":
        gt_files = sorted(glob.glob(os.path.join(gt_dir, "*.txt")))
        assert gt_files, f"no ground-truth files in {gt_dir}"
        for g in gt_files:
            idx = int(os.path.splitext(os.path.basename(g))[0])
            det_path = os.path.join(data_dir, f"{idx:06d}.txt")
            if not os.path.exists(det_path):
                raise FileNotFoundError(
                    f"missing result file {det_path} (the KITTI server "
                    f"requires a result file for every test image)")
            gt_by_img[idx] = parse_label_file(g, is_det=False)
            det_by_img[idx] = parse_label_file(det_path, is_det=True)
    else:
        det_files = sorted(glob.glob(os.path.join(data_dir, "*.txt")))
        assert det_files, f"no detection files in {data_dir}"
        for f in det_files:
            idx = int(os.path.splitext(os.path.basename(f))[0])
            gt_path = os.path.join(gt_dir, f"{idx:06d}.txt")
            if not os.path.exists(gt_path):
                continue
            gt_by_img[idx] = parse_label_file(gt_path, is_det=False)
            det_by_img[idx] = parse_label_file(f, is_det=True)

    metric_names = {0: "detection", 1: "detection_ground", 2: "detection_3d"}
    # overlap matrices depend only on geometry + metric: one cache per
    # metric, shared across classes and difficulties
    metric_caches: Dict[int, Dict] = {m: {} for m in metrics}
    results: Dict[str, Dict] = {}
    for cls in classes:
        cls = cls.lower()
        results[cls] = {}
        for metric in metrics:
            if (protocol == "server" and metric in (1, 2)
                    and not _det_metric_available(det_by_img, cls, metric)):
                continue
            aps = []
            curves = []
            for difficulty in range(3):
                prec, aos_c = eval_class(
                    gt_by_img, det_by_img, cls, difficulty, metric,
                    compute_aos=compute_aos and metric == 0,
                    ov_cache=metric_caches[metric],
                    strict_height=strict_height)
                aps.append(ap_from_curve(prec))
                curves.append(prec)
                if compute_aos and metric == 0:
                    results[cls].setdefault("aos", [0.0] * 3)[difficulty] = ap_from_curve(aos_c)
            name = metric_names[metric]
            results[cls][name] = aps
            stats_path = os.path.join(
                result_dir, f"stats_{cls}_{name}.txt")
            with open(stats_path, "w") as f:
                for prec in curves:
                    f.write(" ".join(f"{p:.6f}" for p in prec) + "\n")
            _plot_pr_curves(result_dir, cls, name, curves)
            print(f"{cls}_{name} AP: {aps[0]:.6f} {aps[1]:.6f} {aps[2]:.6f}")
    return results


def _plot_pr_curves(result_dir: str, cls: str, metric_name: str,
                    curves) -> None:
    """Precision/recall plot per class-metric under ``result_dir/plot/``
    (the reference binary emits the same three-difficulty plot via gnuplot,
    `evaluate_object_3d_offline.cpp` saveAndPlotPlots; matplotlib PNG here).
    Silently skipped when matplotlib is unavailable."""
    from frustum_convnet_tpu_torch.evaluation.plots import save_pr_plot

    save_pr_plot(os.path.join(result_dir, "plot", f"{cls}_{metric_name}.png"),
                 f"{cls} {metric_name}", curves,
                 labels=("Easy", "Moderate", "Hard"))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="KITTI AP evaluation")
    p.add_argument("gt_dir")
    p.add_argument("result_dir")
    p.add_argument("--classes", nargs="+", default=["car", "pedestrian", "cyclist"])
    p.add_argument("--protocol", default="offline", choices=("offline", "server"),
                   help="offline devkit binary (default) or KITTI-server variant")
    args = p.parse_args(argv)
    evaluate(args.gt_dir, args.result_dir, classes=args.classes,
             protocol=args.protocol)


if __name__ == "__main__":
    main()
