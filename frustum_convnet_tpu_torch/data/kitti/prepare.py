"""Offline KITTI frustum extraction (stage 1) — CLI.

Behavioral equivalent of reference `kitti/prepare_data.py:260-687`,
producing pickles interchangeable with the reference (11 labeled / 7
rgb-detection streams; see ``data/pickle_io.py``):

* lidar -> rect-camera frame, image-FOV filter (projection inside the image
  and velo-x > 2 m, ref `kitti/draw_util.py:12-23`);
* per GT object x ``augmentX`` jittered 2D boxes (±10% center shift /
  scale, ref `prepare_data.py:55-77`), crop points whose image projection
  falls in the box;
* frustum angle from the box-center pixel ray at depth 20
  (ref `prepare_data.py:333-340`);
* point labels by 3D-box membership (oriented-box half-space test replacing
  scipy Delaunay — equivalent for convex boxes);
* reject boxes under 25 px height or with zero foreground points
  (ref `prepare_data.py:354`).

KITTI label boxes anchor ``t`` at the *bottom-face center*; stored corner
arrays use the reference order with corners 0-3 at y=t_y (bottom) and 4-7 at
y=t_y-h (`kitti/kitti_util.py:324-359`).
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

from frustum_convnet_tpu_torch.core import geometry_np as gnp
from frustum_convnet_tpu_torch.data import pickle_io, prep_util
from frustum_convnet_tpu_torch.data.kitti.object import KittiObjectDataset


def kitti_object_corners(obj) -> np.ndarray:
    """8 corners (reference order) of a KITTI label object (bottom-anchored)."""
    t = np.asarray(obj.t, dtype=np.float64)
    center = t - np.array([0.0, obj.h / 2.0, 0.0])
    return gnp.box3d_corners(center, (obj.l, obj.w, obj.h), obj.ry)


def random_shift_box2d(box2d, img_height, img_width, shift_ratio=0.1,
                       rng: np.random.Generator | None = None):
    """Jitter a 2D box: center ±r*wh, scale (1±r), clipped to the image."""
    rng = rng or np.random.default_rng()
    xmin, ymin, xmax, ymax = box2d
    w, h = xmax - xmin, ymax - ymin
    cx, cy = (xmin + xmax) / 2.0, (ymin + ymax) / 2.0
    while True:
        cx2 = cx + w * shift_ratio * rng.uniform(-1, 1)
        cy2 = cy + h * shift_ratio * rng.uniform(-1, 1)
        w2 = w * (1 + rng.uniform(-shift_ratio, shift_ratio))
        h2 = h * (1 + rng.uniform(-shift_ratio, shift_ratio))
        new = np.array([cx2 - w2 / 2, cy2 - h2 / 2, cx2 + w2 / 2, cy2 + h2 / 2])
        new[[0, 2]] = np.clip(new[[0, 2]], 0, img_width - 1)
        new[[1, 3]] = np.clip(new[[1, 3]], 0, img_height - 1)
        if new[0] < new[2] and new[1] < new[3]:
            return new


def lidar_in_image_fov_mask(pc_velo, calib, img_height, img_width,
                            clip_distance=2.0):
    """Image-FOV mask for velodyne points (ref draw_util.py:12-23)."""
    pts_2d = calib.velo_to_image(pc_velo[:, :3])
    mask = (
        (pts_2d[:, 0] >= 0) & (pts_2d[:, 0] < img_width)
        & (pts_2d[:, 1] >= 0) & (pts_2d[:, 1] < img_height)
        & (pc_velo[:, 0] > clip_distance)
    )
    return mask, pts_2d


def frustum_angle_from_box(box2d, calib) -> float:
    """-atan2(z, x) of the box-center ray at nominal depth 20 (ref :333-340)."""
    cx, cy = (box2d[0] + box2d[2]) / 2.0, (box2d[1] + box2d[3]) / 2.0
    ray = calib.image_to_rect(np.array([[cx, cy, 20.0]]))[0]
    return float(-np.arctan2(ray[2], ray[0]))


def _prep_frame_gt(data_root, split, perturb_box2d, augmentX, type_whitelist,
                   seed, data_idx):
    """One frame's frustum records. Module-level + per-frame seeded rng so
    the output is identical for any worker count / frame order."""
    dataset = KittiObjectDataset(data_root, split)
    rng = np.random.default_rng((seed, data_idx))
    calib = dataset.get_calibration(data_idx)
    objects = dataset.get_label_objects(data_idx)
    pc_velo = dataset.get_lidar(data_idx)
    pc_rect = np.zeros_like(pc_velo)
    pc_rect[:, :3] = calib.velo_to_rect(pc_velo[:, :3])
    pc_rect[:, 3] = pc_velo[:, 3]
    img_h, img_w = dataset.get_image_size(data_idx)
    fov_mask, pts_2d = lidar_in_image_fov_mask(pc_velo, calib, img_h, img_w)

    out = {k: [] for k in pickle_io.KITTI_LABELED_FIELDS}
    pos_cnt = all_cnt = 0
    for obj in objects:
        if obj.type not in type_whitelist:
            continue
        for _ in range(augmentX):
            if perturb_box2d:
                xmin, ymin, xmax, ymax = random_shift_box2d(
                    obj.box2d, img_h, img_w, 0.1, rng)
            else:
                xmin, ymin, xmax, ymax = obj.box2d
            in_box = (
                (pts_2d[:, 0] >= xmin) & (pts_2d[:, 0] < xmax)
                & (pts_2d[:, 1] >= ymin) & (pts_2d[:, 1] < ymax)
                & fov_mask
            )
            pc_in_box = pc_rect[in_box, :]

            corners = kitti_object_corners(obj)
            label = gnp.points_in_box3d_corners(pc_in_box[:, :3], corners).astype(np.float64)

            # reject small/empty (ref :354)
            if (obj.box2d[3] - obj.box2d[1]) < 25 or label.sum() == 0:
                continue

            out["id"].append(data_idx)
            out["box2d"].append(np.array([xmin, ymin, xmax, ymax]))
            out["box3d"].append(corners)
            out["points"].append(pc_in_box.astype(np.float32, copy=False))
            out["seg"].append(label)
            out["type"].append(obj.type)
            out["heading"].append(obj.ry)
            out["size"].append(np.array([obj.l, obj.w, obj.h]))
            out["frustum_angle"].append(
                frustum_angle_from_box((xmin, ymin, xmax, ymax), calib))
            out["gt_box2d"].append(obj.box2d)
            out["calib"].append(calib.as_dict())
            pos_cnt += label.sum()
            all_cnt += pc_in_box.shape[0]
    return out, pos_cnt, all_cnt


def extract_frustum_data(idx_filename, split, output_filename, data_root,
                         perturb_box2d=False, augmentX=1,
                         type_whitelist=("Car",), seed=3, workers=1):
    """Stage-1 GT frustum extraction (ref `prepare_data.py:260-389`).

    ``workers > 1`` fans the per-frame work over a process pool — the prep
    is the reference pipeline's hours-scale CPU step (SURVEY §3.4); frames
    are independent and the per-frame rng keying makes the output identical
    for any worker count.
    """
    data_idx_list = [int(line.rstrip()) for line in open(idx_filename)]
    work = functools.partial(_prep_frame_gt, data_root, split, perturb_box2d,
                             augmentX, tuple(type_whitelist), seed)
    results = prep_util.parallel_map_frames(work, data_idx_list, workers)
    out = prep_util.merge_frame_outputs(
        [r[0] for r in results], pickle_io.KITTI_LABELED_FIELDS)
    pos_cnt = sum(r[1] for r in results)
    all_cnt = sum(r[2] for r in results)

    n = len(out["id"])
    print(f"total_objects {n}")
    if n:
        print(f"Average pos ratio: {pos_cnt / max(all_cnt, 1):.4f}")
        print(f"Average npoints: {all_cnt / n:.1f}")
    pickle_io.write_stream_pickle(output_filename, out, pickle_io.KITTI_LABELED_FIELDS)
    print(f"saved {output_filename}")
    return n


def extract_frustum_det_data(idx_filename, split, output_filename, data_root,
                             det_filename, perturb_box2d=False, augmentX=1,
                             type_whitelist=("Car",), seed=3):
    """Train-on-detections pickle: 2D dets assigned to GT by IoU (ref :102-257).

    Each external 2D detection whose best GT 2D-IoU clears the threshold
    (0.5 when 'Car' is in the whitelist, else 0.25) yields frustums cut from
    the (optionally jittered) DETECTION box, labeled by the ASSIGNED GT's 3D
    box; 'box2d' stores the det box, 'gt_box2d' the GT's. Same 11-stream
    schema as ``extract_frustum_data``, so the provider can append it via
    ``DATA.EXTEND_FROM_DET`` (`datasets/provider_sample.py:110-126`).
    """
    from frustum_convnet_tpu_torch.core.box_overlaps import bbox_overlaps_2d

    dataset = KittiObjectDataset(data_root, split)
    rng = np.random.default_rng(seed)
    data_idx_list = [int(line.rstrip()) for line in open(idx_filename)]

    det_ids, det_types, det_boxes, det_probs = read_det_file(det_filename)
    dets_by_id: dict = {}
    for i, det_idx in enumerate(det_ids):
        dets_by_id.setdefault(det_idx, []).append(
            {"type": det_types[i], "box2d": det_boxes[i], "prob": det_probs[i]})

    out = {k: [] for k in pickle_io.KITTI_LABELED_FIELDS}
    pos_cnt = all_cnt = 0
    thresh = 0.5 if "Car" in type_whitelist else 0.25
    for data_idx in data_idx_list:
        calib = dataset.get_calibration(data_idx)
        gt_objects = [o for o in dataset.get_label_objects(data_idx)
                      if o.type in type_whitelist]
        det_objects = dets_by_id.get(data_idx)
        if not gt_objects or det_objects is None:
            continue
        gt_boxes_2d = np.stack([np.asarray(o.box2d, np.float64)
                                for o in gt_objects])

        pc_velo = dataset.get_lidar(data_idx)
        pc_rect = np.zeros_like(pc_velo)
        pc_rect[:, :3] = calib.velo_to_rect(pc_velo[:, :3])
        pc_rect[:, 3] = pc_velo[:, 3]
        img_h, img_w = dataset.get_image_size(data_idx)
        fov_mask, pts_2d = lidar_in_image_fov_mask(pc_velo, calib, img_h, img_w)

        for det in det_objects:
            if det["type"] not in type_whitelist:
                continue
            overlap = bbox_overlaps_2d(
                np.asarray(det["box2d"], np.float64).reshape(-1, 4), gt_boxes_2d)[0]
            if overlap.max(0) < thresh:
                continue
            obj = gt_objects[int(overlap.argmax(0))]

            for _ in range(augmentX):
                if perturb_box2d:
                    xmin, ymin, xmax, ymax = random_shift_box2d(
                        det["box2d"], img_h, img_w, 0.1, rng)
                else:
                    xmin, ymin, xmax, ymax = det["box2d"]
                in_box = (
                    (pts_2d[:, 0] >= xmin) & (pts_2d[:, 0] < xmax)
                    & (pts_2d[:, 1] >= ymin) & (pts_2d[:, 1] < ymax)
                    & fov_mask
                )
                pc_in_box = pc_rect[in_box, :]

                corners = kitti_object_corners(obj)
                label = gnp.points_in_box3d_corners(
                    pc_in_box[:, :3], corners).astype(np.float64)

                # reject by the ASSIGNED GT's box height / empty fg (ref :221)
                if (obj.box2d[3] - obj.box2d[1]) < 25 or label.sum() == 0:
                    continue

                out["id"].append(data_idx)
                out["box2d"].append(np.array([xmin, ymin, xmax, ymax]))
                out["box3d"].append(corners)
                out["points"].append(pc_in_box.astype(np.float32, copy=False))
                out["seg"].append(label)
                out["type"].append(obj.type)
                out["heading"].append(obj.ry)
                out["size"].append(np.array([obj.l, obj.w, obj.h]))
                out["frustum_angle"].append(
                    frustum_angle_from_box((xmin, ymin, xmax, ymax), calib))
                out["gt_box2d"].append(obj.box2d)
                out["calib"].append(calib.as_dict())
                pos_cnt += label.sum()
                all_cnt += pc_in_box.shape[0]

    n = len(out["id"])
    print(f"total_objects {n}")
    if n:
        print(f"Average pos ratio: {pos_cnt / max(all_cnt, 1):.4f}")
        print(f"Average npoints: {all_cnt / n:.1f}")
    pickle_io.write_stream_pickle(output_filename, out, pickle_io.KITTI_LABELED_FIELDS)
    print(f"saved {output_filename}")
    return n


def read_det_file(det_filename):
    """Parse ``img_path typeid prob x1 y1 x2 y2`` detection lines (ref :428-446)."""
    det_id2str = {1: "Pedestrian", 2: "Car", 3: "Cyclist"}
    ids, types, probs, boxes = [], [], [], []
    for line in open(det_filename):
        t = line.rstrip().split(" ")
        ids.append(int(os.path.basename(t[0]).rstrip(".png")))
        try:
            types.append(det_id2str[int(t[1])])
        except ValueError:
            types.append(t[1])
        probs.append(float(t[2]))
        boxes.append(np.array([float(x) for x in t[3:7]]))
    return ids, types, boxes, probs


def extract_frustum_data_rgb_detection(det_filename, split, output_filename,
                                       data_root, type_whitelist=("Car",),
                                       img_height_threshold=5,
                                       lidar_point_threshold=1):
    """Frustums from an external 2D detector's boxes (ref :462-568)."""
    dataset = KittiObjectDataset(data_root, split)
    det_ids, det_types, det_boxes, det_probs = read_det_file(det_filename)

    out = {k: [] for k in pickle_io.KITTI_RGBDET_FIELDS}
    cache = {}
    for i in range(len(det_ids)):
        if det_types[i] not in type_whitelist:
            continue
        data_idx = det_ids[i]
        if data_idx not in cache:
            calib = dataset.get_calibration(data_idx)
            pc_velo = dataset.get_lidar(data_idx)
            pc_rect = np.zeros_like(pc_velo)
            pc_rect[:, :3] = calib.velo_to_rect(pc_velo[:, :3])
            pc_rect[:, 3] = pc_velo[:, 3]
            img_h, img_w = dataset.get_image_size(data_idx)
            fov_mask, pts_2d = lidar_in_image_fov_mask(pc_velo, calib, img_h, img_w)
            cache[data_idx] = (calib, pc_rect, pts_2d, fov_mask, img_h, img_w)
        calib, pc_rect, pts_2d, fov_mask, img_h, img_w = cache[data_idx]

        xmin, ymin, xmax, ymax = det_boxes[i]
        in_box = (
            (pts_2d[:, 0] >= xmin) & (pts_2d[:, 0] < xmax)
            & (pts_2d[:, 1] >= ymin) & (pts_2d[:, 1] < ymax)
            & fov_mask
        )
        pc_in_box = pc_rect[in_box, :]
        if ymax - ymin < img_height_threshold or len(pc_in_box) < lidar_point_threshold:
            continue
        out["id"].append(data_idx)
        out["box2d"].append(det_boxes[i])
        out["points"].append(pc_in_box.astype(np.float32, copy=False))
        out["type"].append(det_types[i])
        out["frustum_angle"].append(frustum_angle_from_box(det_boxes[i], calib))
        out["prob"].append(det_probs[i])
        out["calib"].append(calib.as_dict())

    print(f"total_objects {len(out['id'])}")
    pickle_io.write_stream_pickle(output_filename, out, pickle_io.KITTI_RGBDET_FIELDS)
    print(f"saved {output_filename}")
    return len(out["id"])


def get_box3d_dim_statistics(idx_filename, data_root,
                             type_whitelist=("Car", "Pedestrian", "Cyclist")):
    """Per-class mean (l, w, h) over a split — the size-template generator."""
    dataset = KittiObjectDataset(data_root, "training")
    dims = {t: [] for t in type_whitelist}
    for line in open(idx_filename):
        for obj in dataset.get_label_objects(int(line.rstrip())):
            if obj.type in dims:
                dims[obj.type].append([obj.l, obj.w, obj.h])
    stats = {}
    for t, rows in dims.items():
        if rows:
            m = np.mean(rows, axis=0)
            stats[t] = m
            print(f"'{t}': np.array([{m[0]:f},{m[1]:f},{m[2]:f}]),")
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(description="KITTI frustum data preparation (stage 1)")
    p.add_argument("--gen_train", action="store_true")
    p.add_argument("--gen_val", action="store_true")
    p.add_argument("--gen_val_rgb_detection", action="store_true")
    p.add_argument("--gen_trainval", action="store_true",
                   help="trainval split with perturbed GT boxes")
    p.add_argument("--gen_test_rgb_detection", action="store_true",
                   help="test split from RGB detections")
    p.add_argument("--gen_train_det", action="store_true",
                   help="train-on-detections pickle (<prefix>_train_det.pickle,"
                        " consumed via DATA.EXTEND_FROM_DET)")
    p.add_argument("--gen_avg_dim", action="store_true",
                   help="print per-class mean (l, w, h) size templates")
    p.add_argument("--car_only", action="store_true")
    p.add_argument("--people_only", action="store_true")
    p.add_argument("--data_root", default="data/kitti")
    p.add_argument("--save_dir", default="kitti/data/pickle_data")
    p.add_argument("--image_sets_dir", default=None,
                   help="dir with train.txt/val.txt (default <data_root>/image_sets)")
    p.add_argument("--rgb_det_dir", default=None,
                   help="dir with rgb_detection_{train,val}.txt")
    p.add_argument("--workers", type=int, default=1,
                   help="process-pool size for per-frame extraction "
                        "(output identical for any worker count)")
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
            args.data_root, perturb_box2d=True, augmentX=5,
            type_whitelist=whitelist, workers=args.workers)
    if args.gen_val:
        extract_frustum_data(
            os.path.join(sets_dir, "val.txt"), "training",
            os.path.join(args.save_dir, f"{prefix}_val.pickle"),
            args.data_root, perturb_box2d=False, augmentX=1,
            type_whitelist=whitelist, workers=args.workers)
    if args.gen_trainval:
        extract_frustum_data(
            os.path.join(sets_dir, "trainval.txt"), "training",
            os.path.join(args.save_dir, f"{prefix}_trainval.pickle"),
            args.data_root, perturb_box2d=True, augmentX=5,
            type_whitelist=whitelist, workers=args.workers)
    if args.gen_val_rgb_detection:
        det_dir = args.rgb_det_dir or os.path.join("kitti", "rgb_detections")
        extract_frustum_data_rgb_detection(
            os.path.join(det_dir, "rgb_detection_val.txt"), "training",
            os.path.join(args.save_dir, f"{prefix}_val_rgb_detection.pickle"),
            args.data_root, type_whitelist=whitelist)
    if args.gen_test_rgb_detection:
        det_dir = args.rgb_det_dir or os.path.join("kitti", "rgb_detections")
        extract_frustum_data_rgb_detection(
            os.path.join(det_dir, "rgb_detection_test.txt"), "testing",
            os.path.join(args.save_dir, f"{prefix}_test_rgb_detection.pickle"),
            args.data_root, type_whitelist=whitelist)
    if args.gen_train_det:
        det_dir = args.rgb_det_dir or os.path.join("kitti", "rgb_detections")
        extract_frustum_det_data(
            os.path.join(sets_dir, "train.txt"), "training",
            os.path.join(args.save_dir, f"{prefix}_train_det.pickle"),
            args.data_root,
            os.path.join(det_dir, "rgb_detection_train.txt"),
            perturb_box2d=True, augmentX=5, type_whitelist=whitelist)
    if args.gen_avg_dim:
        get_box3d_dim_statistics(os.path.join(sets_dir, "train.txt"),
                                 args.data_root)


if __name__ == "__main__":
    main()
