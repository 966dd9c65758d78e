"""Offline SUN-RGBD frustum extraction — CLI.

Behavioral equivalent of reference `sunrgbd/prepare_data.py:132-452`,
writing single-dict pickles (``sunrgbd_train_aug5x.pickle`` /
``sunrgbd_val.pickle`` / ``sunrgbd_rgb_det_val.pickle``) in the schema the
provider consumes (`datasets/provider_sample_sunrgbd.py:79-111`):

* points are converted upright depth -> upright camera; each frustum crops
  the points whose image projection falls in the (optionally jittered) 2D
  box; at most 2048 points are kept per frustum (random subsample cap);
* frustum angle from the box-center pixel ray at depth 20;
* point labels by membership of the (upright camera) GT box; frustums with
  < 5 foreground points are rejected;
* optional ravel-hash voxel downsample of the scene cloud (off by default);
* detections come from a 19-class pickle (`read_det_pkl_file`) or a txt file
  in the KITTI rgb-detection format.
"""

from __future__ import annotations

import argparse
import functools
import os
import pickle

import numpy as np

from frustum_convnet_tpu_torch.core import geometry_np as gnp
from frustum_convnet_tpu_torch.data import prep_util
from frustum_convnet_tpu_torch.data.sunrgbd.calib import (compute_box3d_upright_depth,
                                                    random_shift_box2d)
from frustum_convnet_tpu_torch.data.sunrgbd.object import SunrgbdObjectDataset

DET_CLASSES_19 = [
    "__background__", "bathtub", "bed", "bookshelf", "box", "chair", "counter",
    "desk", "door", "dresser", "garbage_bin", "lamp", "monitor", "night_stand",
    "pillow", "sink", "sofa", "table", "tv", "toilet",
]
TYPE_WHITELIST_10 = [
    "bathtub", "bed", "bookshelf", "chair", "desk", "dresser", "night_stand",
    "sofa", "table", "toilet",
]

MAX_POINTS_PER_FRUSTUM = 2048
MIN_FG_POINTS = 5


def down_sample(points: np.ndarray, voxel_size: float = 0.01) -> np.ndarray:
    """Ravel-hash voxel downsample -> kept indices (ref :24-53)."""
    coords = np.floor((points - points.min(0)) / voxel_size).astype(np.int64)
    dims = coords.max(0) + 1
    keys = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    _, idx = np.unique(keys, return_index=True)
    return np.sort(idx)


def _frustum_angle(calib, box2d) -> float:
    cx, cy = (box2d[0] + box2d[2]) / 2.0, (box2d[1] + box2d[3]) / 2.0
    center = calib.image_to_upright_camera(np.array([[cx, cy, 20.0]]))[0]
    return float(-np.arctan2(center[2], center[0]))


SUNRGBD_FIELDS = ("id", "box2d", "box3d", "input", "label", "type",
                  "box3d_heading", "box3d_size", "frustum_angle",
                  "calib_K", "calib_R")


def _prep_frame_sunrgbd(sunrgbd_dir, split, type_whitelist, perturb_box2d,
                        augmentX, with_down_sample, seed, data_idx):
    """One frame's frustum records (per-frame seeded rng: output identical
    for any worker count / frame order)."""
    dataset = SunrgbdObjectDataset(sunrgbd_dir, split)
    rng = np.random.default_rng((seed, data_idx))
    out = {k: [] for k in SUNRGBD_FIELDS}
    calib = dataset.get_calibration(data_idx)
    objects = dataset.get_label_objects(data_idx)
    pc_ud = dataset.get_pointcloud(data_idx)
    pc_uc = np.zeros_like(pc_ud)
    pc_uc[:, :3] = calib.upright_depth_to_upright_camera(pc_ud[:, :3])
    pc_uc[:, 3:] = pc_ud[:, 3:]
    if with_down_sample:
        keep = down_sample(pc_uc[:, :3])
        pc_uc, pc_ud = pc_uc[keep], pc_ud[keep]
    img_coords, _ = calib.upright_depth_to_image(pc_ud)

    for obj in objects:
        if obj.classname not in type_whitelist:
            continue
        for _ in range(augmentX):
            box = (random_shift_box2d(obj.box2d, 0.1, rng)
                   if perturb_box2d else obj.box2d)
            xmin, ymin, xmax, ymax = box
            in_box = ((img_coords[:, 0] >= xmin) & (img_coords[:, 0] < xmax)
                      & (img_coords[:, 1] >= ymin) & (img_coords[:, 1] < ymax))
            pc_in = pc_uc[in_box]
            if len(pc_in) > MAX_POINTS_PER_FRUSTUM:
                sel = rng.choice(len(pc_in), MAX_POINTS_PER_FRUSTUM, replace=False)
                pc_in = pc_in[sel]
            corners_ud = compute_box3d_upright_depth(obj)
            corners = calib.upright_depth_to_upright_camera(corners_ud)
            label = gnp.points_in_box3d_corners(pc_in[:, :3], _reorder(corners)).astype(np.float64)
            if label.sum() < MIN_FG_POINTS:
                continue
            out["id"].append(data_idx)
            out["box2d"].append(np.asarray(box))
            out["box3d"].append(corners)
            out["input"].append(pc_in.astype(np.float32, copy=False))
            out["label"].append(label)
            out["type"].append(obj.classname)
            out["box3d_heading"].append(obj.heading_angle)
            # stored sizes are FULL dimensions (2x the label half-sizes)
            out["box3d_size"].append(np.array([obj.l, obj.w, obj.h]) * 2.0)
            out["frustum_angle"].append(_frustum_angle(calib, box))
            out["calib_K"].append(calib.K)
            out["calib_R"].append(calib.Rtilt)
    return out


def extract_frustum_data(sunrgbd_dir, idx_filename, split, output_filename,
                         type_whitelist=TYPE_WHITELIST_10, perturb_box2d=False,
                         augmentX=1, with_down_sample=False, seed=3,
                         workers=1):
    """SUN-RGBD frustum extraction (ref `sunrgbd/prepare_data.py:132-267`).
    ``workers > 1`` fans per-frame work over a spawn-mode process pool."""
    data_idx_list = [int(l.rstrip()) for l in open(idx_filename)]
    work = functools.partial(_prep_frame_sunrgbd, sunrgbd_dir, split,
                             tuple(type_whitelist), perturb_box2d, augmentX,
                             with_down_sample, seed)
    results = prep_util.parallel_map_frames(work, data_idx_list, workers,
                                            chunksize=8)
    out = prep_util.merge_frame_outputs(results, SUNRGBD_FIELDS)
    n = len(out["id"])
    print(f"total_objects {n}")
    with open(output_filename, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"saved {output_filename}")
    return n


def _reorder(corners: np.ndarray) -> np.ndarray:
    """SUN corner layout is already a valid oriented box; the half-space
    membership test only needs a consistent frame, which
    ``points_in_box3d_corners`` reconstructs from any box-shaped corner set
    via its edge vectors — reorder to the reference edge indices."""
    # corners from compute_box3d (upright camera after flip): derive frame
    # from edges c0->c1 (x-ish), c0->c3 (z-ish), c0->c4 (y-ish)
    c = np.asarray(corners, dtype=np.float64)
    center = c.mean(axis=0)
    ex = c[1] - c[0]
    ez = c[3] - c[0]
    ey = c[4] - c[0]
    dims = np.array([np.linalg.norm(ex), np.linalg.norm(ey), np.linalg.norm(ez)])
    axes = np.stack([ex, ey, ez]) / np.maximum(dims[:, None], 1e-12)
    # rebuild in the reference corner order around the centroid
    sx = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * dims[0] / 2
    sy = np.array([1, 1, 1, 1, -1, -1, -1, -1]) * dims[1] / 2
    sz = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * dims[2] / 2
    return center[None] + sx[:, None] * axes[0] + sy[:, None] * axes[1] + sz[:, None] * axes[2]


def read_det_pkl_file(det_file: str):
    """19-class detection pickle -> flat per-detection lists (ref :105-129)."""
    with open(det_file, "rb") as f:
        dets = pickle.load(f)
    ids, types, probs, boxes = [], [], [], []
    num_classes, num_images = len(dets), len(dets[0])
    for i in range(num_images):
        for c in range(1, num_classes):
            for det in dets[c][i]:
                ids.append(i + 1)
                types.append(DET_CLASSES_19[c])
                probs.append(det[4])
                boxes.append(np.asarray(det[:4]))
    return ids, types, boxes, probs


def read_det_txt_file(det_file: str):
    ids, types, boxes, probs = [], [], [], []
    for line in open(det_file):
        t = line.split()
        ids.append(int(t[0]))
        types.append(t[1])
        probs.append(float(t[2]))
        boxes.append(np.array([float(x) for x in t[3:7]]))
    return ids, types, boxes, probs


def extract_frustum_data_rgb_detection(sunrgbd_dir, det_file, split,
                                       output_filename,
                                       type_whitelist=TYPE_WHITELIST_10,
                                       seed=3):
    dataset = SunrgbdObjectDataset(sunrgbd_dir, split)
    if det_file.endswith(".pkl") or det_file.endswith(".pickle"):
        ids, types, boxes, probs = read_det_pkl_file(det_file)
    else:
        ids, types, boxes, probs = read_det_txt_file(det_file)
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("id", "box2d", "input", "type", "box2d_prob",
                           "frustum_angle", "calib_K", "calib_R")}
    cache = {}
    for i in range(len(ids)):
        if types[i] not in type_whitelist:
            continue
        data_idx = ids[i]
        if data_idx not in cache:
            calib = dataset.get_calibration(data_idx)
            pc_ud = dataset.get_pointcloud(data_idx)
            pc_uc = np.zeros_like(pc_ud)
            pc_uc[:, :3] = calib.upright_depth_to_upright_camera(pc_ud[:, :3])
            pc_uc[:, 3:] = pc_ud[:, 3:]
            img_coords, _ = calib.upright_depth_to_image(pc_ud)
            cache[data_idx] = (calib, pc_uc, img_coords)
        calib, pc_uc, img_coords = cache[data_idx]
        xmin, ymin, xmax, ymax = boxes[i]
        in_box = ((img_coords[:, 0] >= xmin) & (img_coords[:, 0] < xmax)
                  & (img_coords[:, 1] >= ymin) & (img_coords[:, 1] < ymax))
        pc_in = pc_uc[in_box]
        if len(pc_in) == 0:
            continue
        if len(pc_in) > MAX_POINTS_PER_FRUSTUM:
            sel = rng.choice(len(pc_in), MAX_POINTS_PER_FRUSTUM, replace=False)
            pc_in = pc_in[sel]
        out["id"].append(data_idx)
        out["box2d"].append(np.asarray(boxes[i]))
        out["input"].append(pc_in.astype(np.float32, copy=False))
        out["type"].append(types[i])
        out["box2d_prob"].append(probs[i])
        out["frustum_angle"].append(_frustum_angle(calib, boxes[i]))
        out["calib_K"].append(calib.K)
        out["calib_R"].append(calib.Rtilt)
    n = len(out["id"])
    print(f"total_objects {n}")
    with open(output_filename, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"saved {output_filename}")
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="SUN-RGBD frustum data preparation")
    p.add_argument("--gen_train", action="store_true")
    p.add_argument("--gen_val", action="store_true")
    p.add_argument("--gen_val_rgb_detection", action="store_true")
    p.add_argument("--sunrgbd_dir", default="sunrgbd/mysunrgbd")
    p.add_argument("--save_dir", default="sunrgbd/data/pickle_data")
    p.add_argument("--train_idx", default="sunrgbd/image_sets/train.txt")
    p.add_argument("--val_idx", default="sunrgbd/image_sets/val.txt")
    p.add_argument("--det_file", default="sunrgbd/sunrgbd_2d_det_val.pkl")
    p.add_argument("--num_classes", type=int, choices=(10, 19), default=10)
    p.add_argument("--workers", type=int, default=1,
                   help="process-pool size (output identical for any count)")
    args = p.parse_args(argv)

    whitelist = TYPE_WHITELIST_10 if args.num_classes == 10 else DET_CLASSES_19[1:]
    os.makedirs(args.save_dir, exist_ok=True)
    if args.gen_train:
        extract_frustum_data(
            args.sunrgbd_dir, args.train_idx, "training",
            os.path.join(args.save_dir, "sunrgbd_train_aug5x.pickle"),
            whitelist, perturb_box2d=True, augmentX=5, workers=args.workers)
    if args.gen_val:
        extract_frustum_data(
            args.sunrgbd_dir, args.val_idx, "training",
            os.path.join(args.save_dir, "sunrgbd_val.pickle"),
            whitelist, perturb_box2d=False, augmentX=1, workers=args.workers)
    if args.gen_val_rgb_detection:
        extract_frustum_data_rgb_detection(
            args.sunrgbd_dir, args.det_file, "training",
            os.path.join(args.save_dir, "sunrgbd_rgb_det_val.pickle"), whitelist)


if __name__ == "__main__":
    main()
