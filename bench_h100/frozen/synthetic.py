"""Synthetic KITTI frustums made in memory from a seed, many frames at once.

Frozen from two files of the port at commit 63f8e5d, with the disk taken out
and the frames drawn together (the same distributions; the draws come in
another order than the per-frame generator's):

* the scene: ``frustum_convnet_tpu_torch/data/kitti/synthetic.py``
  (``make_synthetic_kitti`` without ``difficulty_mix``): per frame, objects
  of ``CLASS_SPECS`` at 8-35 m (cars) or 5-20 m (pedestrians, cyclists),
  a quarter of the depth to either side, 400 surface points each, a road
  plane of 3000 points, the clipped 2D box of each object (at least 30 px
  tall) and a detector's box jittered by 5% with a probability in [0.7,
  0.99). No velodyne, calib, label or image file is written, so the points
  stay in the rectified camera frame.
* the frustum cut: ``frustum_convnet_tpu_torch/data/kitti/prepare.py``
  (``extract_frustum_data_rgb_detection`` for served frustums,
  ``_prep_frame_gt`` with ``perturb_box2d`` for training ones): the frame's
  points whose pixel lies inside the 2D box, the frustum angle of the box
  center, and for training the 3D box's segmentation, a box perturbed by
  ``random_shift_box2d`` and the rejection of boxes under 25 px or with no
  object point (served: under 5 px or no point). The field of view is the
  image (every point lies more than 2 m ahead, so the prep's 2 m clip
  removes none).
"""

from __future__ import annotations

import numpy as np

from bench_h100.frozen import geometry as gnp

# A realistic KITTI P2 (the generator's calibration)
P2 = np.array([
    [721.5377, 0.0, 609.5593, 44.85728],
    [0.0, 721.5377, 172.854, 0.2163791],
    [0.0, 0.0, 1.0, 0.002745884],
])
IMG_W, IMG_H = 1242, 375
OBJECT_POINTS, ROAD_POINTS = 400, 3000

CLASS_SPECS = {
    # class -> ((l, w, h) means, (l, w, h) jitter sigmas)
    "Car": ((3.9, 1.6, 1.5), (0.2, 0.1, 0.1)),
    "Pedestrian": ((0.8, 0.6, 1.75), (0.1, 0.05, 0.1)),
    "Cyclist": ((1.75, 0.6, 1.75), (0.1, 0.05, 0.1)),
}
# corner signs of the reference's box corners (bottom face first), as (l, h, w) multiples
_SX = np.array([1, 1, -1, -1, 1, 1, -1, -1]) / 2.0
_SY = np.array([1, 1, 1, 1, -1, -1, -1, -1]) / 2.0
_SZ = np.array([1, -1, -1, 1, 1, -1, -1, 1]) / 2.0


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


def frustum_angles(box2d: np.ndarray, P) -> np.ndarray:
    """-atan2(z, x) of each box-center ray at nominal depth 20; box2d (n, 4)."""
    cx = (box2d[:, 0] + box2d[:, 2]) / 2.0
    cy = (box2d[:, 1] + box2d[:, 3]) / 2.0
    ray = gnp.project_image_to_rect(np.stack([cx, cy, np.full_like(cx, 20.0)], axis=1), P)
    return -np.arctan2(ray[:, 2], ray[:, 0])


def _pixels(cloud):
    """(u, v) pixels of rect-frame points (..., >=3) through ``P2``."""
    x, y, z = (cloud[..., k].astype(np.float64) for k in range(3))
    w = P2[2, 0] * x + P2[2, 1] * y + P2[2, 2] * z + P2[2, 3]
    return ((P2[0, 0] * x + P2[0, 1] * y + P2[0, 2] * z + P2[0, 3]) / w,
            (P2[1, 0] * x + P2[1, 1] * y + P2[1, 2] * z + P2[1, 3]) / w)


def _rot_y(ry: np.ndarray) -> np.ndarray:
    """(n, 3, 3) rotations about y."""
    c, s = np.cos(ry), np.sin(ry)
    z, o = np.zeros_like(ry), np.ones_like(ry)
    return np.stack([np.stack([c, z, s], -1), np.stack([z, o, z], -1),
                     np.stack([-s, z, c], -1)], axis=1)


def _scenes(rng, frames: int, classes, per_frame: int) -> dict:
    """Objects (frames * per_frame, ...) and frame clouds (frames, n, 4)."""
    n = frames * per_frame
    cls = rng.integers(len(classes), size=n)
    means = np.array([CLASS_SPECS[classes[c]][0] for c in cls])
    sigmas = np.array([CLASS_SPECS[classes[c]][1] for c in cls])
    is_car = np.array([classes[c] == "Car" for c in cls])
    depth = np.where(is_car, rng.uniform(8, 35, n), rng.uniform(5, 20, n))
    lateral = rng.uniform(-0.25, 0.25, n) * depth
    lwh = means + rng.normal(0, 1, (n, 3)) * sigmas
    ry = rng.uniform(-np.pi, np.pi, n)
    center = np.stack([lateral, 1.65 - lwh[:, 2] / 2, depth], axis=1)
    rot = _rot_y(ry)
    local = rng.uniform(-0.5, 0.5, (n, OBJECT_POINTS, 3)) * lwh[:, None, [0, 2, 1]]
    clouds = np.einsum("opk,ojk->opj", local, rot) + center[:, None]
    corners = np.einsum("ojk,ock->ocj", rot, np.stack(
        [_SX * lwh[:, :1], _SY * lwh[:, 2:3], _SZ * lwh[:, 1:2]], axis=-1)) + center[:, None]
    cu, cv = _pixels(corners)
    xmin, xmax = np.clip(cu.min(1), 0, IMG_W - 1), np.clip(cu.max(1), 0, IMG_W - 1)
    ymin, ymax = np.clip(cv.min(1), 0, IMG_H - 1), np.clip(cv.max(1), 0, IMG_H - 1)
    ymax = np.where(ymax - ymin < 30, np.minimum(IMG_H - 1, ymin + 30), ymax)
    box2d = np.stack([xmin, ymin, xmax, ymax], axis=1)
    jw, jh = (xmax - xmin) * 0.05, (ymax - ymin) * 0.05
    d = rng.uniform(-1, 1, (n, 4)) * np.stack([jw, jh, jw, jh], axis=1)
    det = np.stack([np.maximum(0, xmin + d[:, 0]), np.maximum(0, ymin + d[:, 1]),
                    np.minimum(IMG_W - 1, xmax + d[:, 2]),
                    np.minimum(IMG_H - 1, ymax + d[:, 3])], axis=1)
    road = np.stack([rng.uniform(-20, 20, (frames, ROAD_POINTS)),
                     1.65 + rng.normal(0, 0.02, (frames, ROAD_POINTS)),
                     rng.uniform(3, 60, (frames, ROAD_POINTS))], axis=-1)
    pc = np.concatenate([road, clouds.reshape(frames, per_frame * OBJECT_POINTS, 3)], axis=1)
    pc = np.concatenate([pc, rng.uniform(0, 1, pc.shape[:2] + (1,))], axis=-1).astype(np.float32)
    return {"type": [classes[c] for c in cls], "center": center, "size": lwh, "ry": ry,
            "corners": corners, "box2d": box2d, "det_box2d": det,
            "prob": rng.uniform(0.7, 0.99, n), "cloud": pc}


def make_frustums(rng: np.random.Generator, count: int, classes=("Car",),
                  per_frame: int = 4, labeled: bool = False) -> dict:
    """``count`` frustums, ``per_frame`` objects a frame, drawn from ``rng``.

    Served frustums (``labeled`` False) are cut by the detector's box, with
    the detector's probability; training ones by a box perturbed from the
    object's 2D box, with the object's segmentation. Every record also keeps
    its object (``center``, ``size`` as (l, w, h), ``ry``), from which the
    benchmark derives the label-rule foreground. Returns a dict of lists,
    one entry a frustum: id (frame), type, box2d, points (n, 4) float32,
    frustum_angle, prob, center, size, ry, and with ``labeled`` also box3d
    (corners), seg and heading.
    """
    keys = ["id", "type", "box2d", "points", "prob", "center", "size", "ry"]
    keys += ["box3d", "seg", "heading"] if labeled else []
    out = {k: [] for k in keys}
    first = 0
    while len(out["id"]) < count:
        frames = (count - len(out["id"])) // per_frame + 2
        sc = _scenes(rng, frames, classes, per_frame)
        cloud = sc["cloud"]
        u, v = _pixels(cloud)
        in_fov = (u >= 0) & (u < IMG_W) & (v >= 0) & (v < IMG_H)
        if labeled:
            boxes = np.stack([random_shift_box2d(b, IMG_H, IMG_W, 0.1, rng) for b in sc["box2d"]])
        else:
            boxes = sc["det_box2d"]
        fb = boxes.reshape(frames, per_frame, 4, 1)
        u, v, in_fov = u[:, None], v[:, None], in_fov[:, None]
        inside = (in_fov & (u >= fb[:, :, 0]) & (u < fb[:, :, 2])
                  & (v >= fb[:, :, 1]) & (v < fb[:, :, 3])).reshape(len(boxes), -1)
        for o, box in enumerate(boxes):
            f = o // per_frame
            pts = cloud[f][inside[o]]
            if labeled:
                seg = gnp.points_in_box3d_corners(pts[:, :3], sc["corners"][o]).astype(np.float64)
                if sc["box2d"][o, 3] - sc["box2d"][o, 1] < 25 or seg.sum() == 0:
                    continue
                out["box3d"].append(sc["corners"][o])
                out["seg"].append(seg)
                out["heading"].append(float(sc["ry"][o]))
            elif box[3] - box[1] < 5 or len(pts) < 1:
                continue
            out["id"].append(first + int(f))
            out["box2d"].append(np.asarray(box, np.float64))
            out["points"].append(pts)
            for k in ("type", "prob", "center", "size", "ry"):
                out[k].append(sc[k][o])
        first += frames
    out = {k: v[:count] for k, v in out.items()}
    out["frustum_angle"] = list(frustum_angles(np.stack(out["box2d"]), P2))
    return out
