"""Offline KITTI frustum extraction for the refinement stage — CLI.

Behavioral equivalent of reference `kitti/prepare_data_refine.py`,
producing refine pickles interchangeable with the reference (13 labeled /
10 rgb-detection streams; see ``data/pickle_io.py``). Three extraction paths:

* **GT path** (train): enlarge each GT box x1.2, optionally jitter it
  (±5% center/size shift + ±0.05pi rotation, ref :203-236), crop the points
  inside the enlarged cuboid, label them by true-box membership, and store
  the jittered enlarged box as the "predicted" box (ref :239-403);
* **det-assignment path** (train on stage-1 detections): read a stage-1
  result dir, assign each detection to a GT by rotated 3D IoU >= 0.5, keep
  matched pairs (ref :406-592);
* **rgb-detection path** (val/test): read a stage-1 result dir, cut the
  frustum from each predicted box x1.2, keep the detection score
  (ref :649-773). ``--gen_from_folder`` consumes any result dir (ref
  :917-929).

The stage boundary is KITTI-format txt label files, so stages remain
mix-and-matchable with reference artifacts (SURVEY.md "Two-stage plumbing").
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np

from frustum_convnet_tpu_torch.core import geometry_np as gnp
from frustum_convnet_tpu_torch.core.iou_np import rotated_iou_3d_np
from frustum_convnet_tpu_torch.data import pickle_io, prep_util
from frustum_convnet_tpu_torch.data.kitti.calib import read_label
from frustum_convnet_tpu_torch.data.kitti.object import KittiObjectDataset
from frustum_convnet_tpu_torch.data.kitti.prepare import (frustum_angle_from_box,
                                                    lidar_in_image_fov_mask)

ENLARGE_RATIO = 1.2


def obj_to_center_array(obj) -> np.ndarray:
    """(cx, cy, cz, l, w, h, ry) with cy moved from bottom to center."""
    cx, cy, cz = obj.t
    return np.array([cx, cy - obj.h / 2.0, cz, obj.l, obj.w, obj.h, obj.ry])


def center_array_corners(arr: np.ndarray) -> np.ndarray:
    return gnp.box3d_corners(arr[:3], arr[3:6], arr[6])


def random_shift_rotate_box3d(arr: np.ndarray, shift_ratio: float = 0.1,
                              rng: np.random.Generator | None = None) -> np.ndarray:
    """Jitter a center-parameterized 3D box (ref :203-236)."""
    rng = rng or np.random.default_rng()
    r = shift_ratio
    cx, cy, cz, l, w, h, angle = arr
    angle = angle + np.pi
    while True:
        l1 = l * (1 + r * rng.uniform(-1, 1))
        h1 = h * (1 + r * rng.uniform(-1, 1))
        w1 = w * (1 + r * rng.uniform(-1, 1))
        cx1 = cx + l * r * rng.uniform(-1, 1)
        cy1 = cy + h * r * rng.uniform(-1, 1)
        cz1 = cz + w * r * rng.uniform(-1, 1)
        angle1 = (angle + r * rng.uniform(-1, 1) * np.pi) % (2 * np.pi) - np.pi
        if l1 > 0 and h1 > 0 and w1 > 0:
            return np.array([cx1, cy1, cz1, l1, w1, h1, angle1])


def _frame_points_rect(dataset, calib, data_idx):
    pc_velo = dataset.get_lidar(data_idx)
    pc_rect = np.zeros_like(pc_velo)
    pc_rect[:, :3] = calib.velo_to_rect(pc_velo[:, :3])
    pc_rect[:, 3] = pc_velo[:, 3]
    img_h, img_w = dataset.get_image_size(data_idx)
    fov_mask, _ = lidar_in_image_fov_mask(pc_velo, calib, img_h, img_w)
    return pc_rect[fov_mask]


def _prep_frame_refine_gt(data_root, split, perturb_box3d, augmentX,
                          type_whitelist, remove_diff, seed, data_idx):
    """One frame's refine-stage records (per-frame seeded rng: output is
    identical for any worker count / frame order)."""
    dataset = KittiObjectDataset(data_root, split)
    rng = np.random.default_rng((seed, data_idx))
    out = {k: [] for k in pickle_io.REFINE_LABELED_FIELDS}
    calib = dataset.get_calibration(data_idx)
    pc_rect = _frame_points_rect(dataset, calib, data_idx)
    for obj in dataset.get_label_objects(data_idx):
        if obj.type not in type_whitelist:
            continue
        if remove_diff and (obj.occlusion > 2 or obj.truncation > 0.5
                            or obj.box2d[3] - obj.box2d[1] < 25):
            continue
        obj_array = obj_to_center_array(obj)
        gt_corners = center_array_corners(obj_array)
        enlarge = obj_array.copy()
        enlarge[3:6] *= ENLARGE_RATIO
        for _ in range(augmentX):
            pred = (random_shift_rotate_box3d(enlarge, 0.05, rng)
                    if perturb_box3d else enlarge)
            pred_corners = center_array_corners(pred)
            in_cuboid = gnp.points_in_box3d_corners(pc_rect[:, :3], pred_corners)
            pc_in = pc_rect[in_cuboid]
            label = gnp.points_in_box3d_corners(pc_in[:, :3], gt_corners).astype(np.float64)
            if label.sum() == 0:
                continue
            out["id"].append(data_idx)
            out["box3d"].append(gt_corners)
            out["points"].append(pc_in.astype(np.float32, copy=False))
            out["seg"].append(label)
            out["type"].append(obj.type)
            out["heading"].append(obj.ry)
            out["size"].append(np.array([obj.l, obj.w, obj.h]))
            out["frustum_angle"].append(float(-np.arctan2(pred[2], pred[0])))
            out["box2d"].append(obj.box2d)
            out["calib"].append(calib.as_dict())
            out["pred_box3d"].append(pred_corners)
            out["pred_box3d_size"].append(pred[3:6])
            out["pred_box3d_angle"].append(pred[6])
    return out


def extract_frustum_data(idx_filename, split, output_filename, data_root,
                         perturb_box3d=False, augmentX=1,
                         type_whitelist=("Car",), remove_diff=False, seed=3,
                         workers=1):
    """GT path: pseudo-predictions from jittered enlarged GT boxes.

    ``workers > 1`` fans per-frame extraction over a spawn-mode process pool
    (same contract as stage-1 `prepare.extract_frustum_data`).
    """
    data_idx_list = [int(l.rstrip()) for l in open(idx_filename)]
    work = functools.partial(_prep_frame_refine_gt, data_root, split,
                             perturb_box3d, augmentX, tuple(type_whitelist),
                             remove_diff, seed)
    results = prep_util.parallel_map_frames(work, data_idx_list, workers)
    out = prep_util.merge_frame_outputs(results,
                                        pickle_io.REFINE_LABELED_FIELDS)
    n = len(out["id"])
    print(f"total_objects {n}")
    pickle_io.write_stream_pickle(output_filename, out, pickle_io.REFINE_LABELED_FIELDS)
    print(f"saved {output_filename}")
    return n


def extract_frustum_det_data(idx_filename, split, output_filename, data_root,
                             res_label_dir, type_whitelist=("Car",),
                             iou_threshold=0.5):
    """Det-assignment path: stage-1 dets matched to GT by 3D IoU (ref :406-592)."""
    dataset = KittiObjectDataset(data_root, split)
    out = {k: [] for k in pickle_io.REFINE_LABELED_FIELDS}
    for data_idx in [int(l.rstrip()) for l in open(idx_filename)]:
        det_path = os.path.join(res_label_dir, f"{data_idx:06d}.txt")
        if not os.path.exists(det_path):
            continue
        calib = dataset.get_calibration(data_idx)
        pc_rect = _frame_points_rect(dataset, calib, data_idx)
        gts = [o for o in dataset.get_label_objects(data_idx)
               if o.type in type_whitelist]
        dets = [o for o in read_label(det_path) if o.type in type_whitelist]
        if not gts or not dets:
            continue
        gt_corners_all = [center_array_corners(obj_to_center_array(g)) for g in gts]
        for det in dets:
            det_array = obj_to_center_array(det)
            det_corners = center_array_corners(det_array)
            ious = [rotated_iou_3d_np(det_corners, gc)[1] for gc in gt_corners_all]
            gi = int(np.argmax(ious))
            if ious[gi] < iou_threshold:
                continue
            gt, gt_corners = gts[gi], gt_corners_all[gi]
            enlarge = det_array.copy()
            enlarge[3:6] *= ENLARGE_RATIO
            pred_corners = center_array_corners(enlarge)
            in_cuboid = gnp.points_in_box3d_corners(pc_rect[:, :3], pred_corners)
            pc_in = pc_rect[in_cuboid]
            label = gnp.points_in_box3d_corners(pc_in[:, :3], gt_corners).astype(np.float64)
            if label.sum() == 0:
                continue
            out["id"].append(data_idx)
            out["box3d"].append(gt_corners)
            out["points"].append(pc_in.astype(np.float32, copy=False))
            out["seg"].append(label)
            out["type"].append(gt.type)
            out["heading"].append(gt.ry)
            out["size"].append(np.array([gt.l, gt.w, gt.h]))
            out["frustum_angle"].append(float(-np.arctan2(enlarge[2], enlarge[0])))
            out["box2d"].append(gt.box2d)
            out["calib"].append(calib.as_dict())
            out["pred_box3d"].append(pred_corners)
            out["pred_box3d_size"].append(enlarge[3:6])
            out["pred_box3d_angle"].append(enlarge[6])
    n = len(out["id"])
    print(f"total_objects {n}")
    pickle_io.write_stream_pickle(output_filename, out, pickle_io.REFINE_LABELED_FIELDS)
    print(f"saved {output_filename}")
    return n


def extract_frustum_data_rgb_detection(idx_filename, split, output_filename,
                                       data_root, res_label_dir,
                                       type_whitelist=("Car",),
                                       img_height_threshold=5,
                                       lidar_point_threshold=1):
    """rgb-detection path: frustums from stage-1 result-dir boxes (ref :649-773)."""
    dataset = KittiObjectDataset(data_root, split)
    out = {k: [] for k in pickle_io.REFINE_RGBDET_FIELDS}
    for data_idx in [int(l.rstrip()) for l in open(idx_filename)]:
        det_path = os.path.join(res_label_dir, f"{data_idx:06d}.txt")
        if not os.path.exists(det_path):
            continue
        calib = dataset.get_calibration(data_idx)
        pc_rect = _frame_points_rect(dataset, calib, data_idx)
        for obj in read_label(det_path):
            if obj.type not in type_whitelist:
                continue
            xmin, ymin, xmax, ymax = obj.box2d
            arr = obj_to_center_array(obj)
            enlarge = arr.copy()
            enlarge[3:6] *= ENLARGE_RATIO
            pred_corners = center_array_corners(enlarge)
            in_cuboid = gnp.points_in_box3d_corners(pc_rect[:, :3], pred_corners)
            pc_in = pc_rect[in_cuboid]
            if (ymax - ymin < img_height_threshold or xmax - xmin < 1
                    or len(pc_in) < lidar_point_threshold):
                continue
            out["id"].append(data_idx)
            out["box2d"].append(obj.box2d)
            out["points"].append(pc_in.astype(np.float32, copy=False))
            out["type"].append(obj.type)
            out["frustum_angle"].append(float(-np.arctan2(enlarge[2], enlarge[0])))
            out["prob"].append(obj.score if obj.score is not None else 1.0)
            out["calib"].append(calib.as_dict())
            out["pred_box3d"].append(pred_corners)
            out["pred_box3d_size"].append(enlarge[3:6])
            out["pred_box3d_angle"].append(enlarge[6])
    n = len(out["id"])
    print(f"total_objects {n}")
    pickle_io.write_stream_pickle(output_filename, out, pickle_io.REFINE_RGBDET_FIELDS)
    print(f"saved {output_filename}")
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="KITTI refine-stage frustum preparation")
    p.add_argument("--gen_train", action="store_true")
    p.add_argument("--workers", type=int, default=1,
                   help="process-pool size for the GT path (output identical "
                        "for any worker count)")
    p.add_argument("--gen_val", action="store_true")
    p.add_argument("--gen_val_det", action="store_true",
                   help="val pseudo-preds from stage-1 result dir (det assignment)")
    p.add_argument("--gen_val_rgb_detection", action="store_true")
    p.add_argument("--gen_from_folder", default="",
                   help="cut rgb-detection frustums from an arbitrary result dir")
    p.add_argument("--car_only", action="store_true")
    p.add_argument("--people_only", action="store_true")
    p.add_argument("--data_root", default="data/kitti")
    p.add_argument("--save_dir", default="kitti/data/pickle_data_refine")
    p.add_argument("--image_sets_dir", default=None)
    p.add_argument("--train_res_dir", default="output/car_train/val_nms/result/data",
                   help="stage-1 result dir for det-assignment extraction")
    p.add_argument("--val_res_dir", default="output/car_train/val_nms/result/data",
                   help="stage-1 result dir for rgb-detection extraction")
    args = p.parse_args(argv)

    np.random.seed(3)
    sets_dir = args.image_sets_dir or os.path.join(args.data_root, "image_sets")
    os.makedirs(args.save_dir, exist_ok=True)

    if args.car_only:
        prefix, whitelist = "frustum_caronly", ("Car",)
    elif args.people_only:
        prefix, whitelist = "frustum_pedcyc", ("Pedestrian", "Cyclist")
    else:
        prefix, whitelist = "frustum_carpedcyc", ("Car", "Pedestrian", "Cyclist")

    if args.gen_train:
        extract_frustum_data(
            os.path.join(sets_dir, "train.txt"), "training",
            os.path.join(args.save_dir, f"{prefix}_train.pickle"),
            args.data_root, perturb_box3d=True, augmentX=5,
            type_whitelist=whitelist, workers=args.workers)
    if args.gen_val:
        extract_frustum_data(
            os.path.join(sets_dir, "val.txt"), "training",
            os.path.join(args.save_dir, f"{prefix}_val.pickle"),
            args.data_root, perturb_box3d=False, augmentX=1,
            type_whitelist=whitelist)
    if args.gen_val_det:
        extract_frustum_det_data(
            os.path.join(sets_dir, "train.txt"), "training",
            os.path.join(args.save_dir, f"{prefix}_train_det.pickle"),
            args.data_root, args.train_res_dir, type_whitelist=whitelist)
    if args.gen_val_rgb_detection:
        extract_frustum_data_rgb_detection(
            os.path.join(sets_dir, "val.txt"), "training",
            os.path.join(args.save_dir, f"{prefix}_val_rgb_detection.pickle"),
            args.data_root, args.val_res_dir, type_whitelist=whitelist)
    if args.gen_from_folder:
        extract_frustum_data_rgb_detection(
            os.path.join(sets_dir, "val.txt"), "training",
            os.path.join(args.save_dir, f"{prefix}_val_rgb_detection.pickle"),
            args.data_root, args.gen_from_folder, type_whitelist=whitelist)


if __name__ == "__main__":
    main()
