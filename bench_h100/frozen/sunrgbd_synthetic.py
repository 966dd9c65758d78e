"""Synthetic SUN-RGBD frustums made in memory from a seed, frame by frame.

Frozen from two files of the port at commit 63f8e5d, with the disk taken out
(the same distributions; the draws come in another order than the
per-frame generator's):

* the scene: ``frustum_convnet_tpu_torch/data/sunrgbd/synthetic.py``
  (``make_synthetic_sunrgbd``): per frame, a camera tilted by up to 0.1 rad
  (``Rtilt``) behind the generator's intrinsics, objects standing on the
  floor at 1.5-5 m ahead and up to 0.3 of that to either side, with any
  heading, their half sizes the class's mean times U(0.9, 1.1), 500 points
  spread through each box, a floor of 4000 points over 8 x 7.5 m, an RGB
  colour a point, and a 2D detector's box: the projected box's bounds, at
  the detection file's two decimals, with a probability in [0.6, 0.95) at
  three. The generator draws 4 of the classes; here an object's class is
  any of the 10 the SUN-RGBD model is trained on (``TYPE_WHITELIST_10``),
  each at its mean size (``data/dataset_info.py``, commit d5d2a0c).
* the frustum cut: ``frustum_convnet_tpu_torch/data/sunrgbd/prepare.py``
  (``extract_frustum_data_rgb_detection``): the frame's points, upright
  depth to upright camera, whose pixel lies inside the detector's box,
  skipped when none does, cut to 2048 drawn without replacement where more
  do; the frustum angle of the box center's ray at depth 20. The SUN-RGBD
  calibration conventions are ``data/sunrgbd/calib.py``'s, copied here.
"""

from __future__ import annotations

import numpy as np

K = np.array([[529.5, 0.0, 365.0], [0.0, 529.5, 265.0], [0.0, 0.0, 1.0]])
CLASSES = ("bathtub", "bed", "bookshelf", "chair", "desk", "dresser", "night_stand",
           "sofa", "table", "toilet")
MEAN_SIZE = {  # (l, w, h), full sizes
    "bathtub": (0.765840, 1.398258, 0.472728),
    "bed": (2.114256, 1.620300, 0.927272),
    "bookshelf": (0.404671, 1.071108, 1.688889),
    "chair": (0.591958, 0.552978, 0.827272),
    "desk": (0.695190, 1.346299, 0.736364),
    "dresser": (0.528526, 1.002642, 1.172878),
    "night_stand": (0.500618, 0.632163, 0.683424),
    "sofa": (0.923508, 1.867419, 0.845495),
    "table": (0.791118, 1.279516, 0.718182),
    "toilet": (0.699104, 0.454178, 0.756250),
}
OBJECT_POINTS, FLOOR_POINTS = 500, 4000
MAX_POINTS_PER_FRUSTUM = 2048


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def flip_axis_to_camera(pc: np.ndarray) -> np.ndarray:
    """(x right, y fwd, z up) -> (x right, y down, z fwd)."""
    out = pc[:, [0, 2, 1]].copy()
    out[:, 1] *= -1
    return out


def flip_axis_to_depth(pc: np.ndarray) -> np.ndarray:
    """(x right, y down, z fwd) -> (x right, y fwd, z up)."""
    out = pc[:, [0, 2, 1]].copy()
    out[:, 2] *= -1
    return out


def upright_depth_to_image(pc: np.ndarray, Rtilt: np.ndarray, K: np.ndarray) -> np.ndarray:
    """(u, v) pixels of upright-depth points."""
    uv = flip_axis_to_camera((Rtilt.T @ pc[:, :3].T).T) @ K.T
    return uv[:, :2] / uv[:, 2:3]


def image_to_upright_camera(uv_depth: np.ndarray, K: np.ndarray, Rtilt: np.ndarray):
    """Pixel (u, v) + depth -> upright camera (the provider's ladders too)."""
    x = (uv_depth[:, 0] - K[0, 2]) * uv_depth[:, 2] / K[0, 0]
    y = (uv_depth[:, 1] - K[1, 2]) * uv_depth[:, 2] / K[1, 1]
    depth = flip_axis_to_depth(np.stack([x, y, uv_depth[:, 2]], axis=1))
    return flip_axis_to_camera((Rtilt @ depth.T).T)


def box_corners(centroid, half_lwh, heading: float) -> np.ndarray:
    """8 corners in upright depth of a box with half sizes (l, w, h)."""
    l, w, h = half_lwh
    x = np.array([-l, l, l, -l, -l, l, l, -l])
    y = np.array([w, w, -w, -w, w, w, -w, -w])
    z = np.array([h, h, h, h, -h, -h, -h, -h])
    return (rotz(-heading) @ np.stack([x, y, z])).T + np.asarray(centroid)[None, :]


def _frame(rng, per_frame: int, classes) -> dict:
    """One scene: its calibration, objects, detections and cloud."""
    tilt = rng.uniform(-0.1, 0.1)
    c, s = np.cos(tilt), np.sin(tilt)
    Rtilt = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)
    objs, clouds = [], []
    for _ in range(per_frame):
        cls = classes[rng.integers(len(classes))]
        l, w, h = MEAN_SIZE[cls]
        w, l, h = np.array([w / 2, l / 2, h / 2]) * rng.uniform(0.9, 1.1, 3)  # halves
        depth_fwd = rng.uniform(1.5, 5.0)
        centroid = np.array([rng.uniform(-0.3, 0.3) * depth_fwd, depth_fwd, h])
        heading = rng.uniform(-np.pi, np.pi)
        local = rng.uniform(-1, 1, (OBJECT_POINTS, 3)) * np.array([l, w, h])
        clouds.append((rotz(-heading) @ local.T).T + centroid[None])
        uv = upright_depth_to_image(box_corners(centroid, (l, w, h), heading), Rtilt, K)
        box = np.round(np.concatenate([uv.min(0), uv.max(0)]), 2)
        objs.append({"type": cls, "box2d": box, "prob": round(rng.uniform(0.6, 0.95), 3),
                     "center": flip_axis_to_camera(centroid[None])[0],
                     "size": np.array([l, w, h]) * 2.0, "heading": heading})
    floor = np.stack([rng.uniform(-4, 4, FLOOR_POINTS), rng.uniform(0.5, 8.0, FLOOR_POINTS),
                      rng.normal(0, 0.01, FLOOR_POINTS)], axis=1)
    pc = np.concatenate([floor] + clouds, axis=0)
    pc = np.hstack([pc, rng.uniform(0, 1, (len(pc), 3))]).astype(np.float32)
    return {"Rtilt": Rtilt, "objects": objs, "cloud": pc}


def make_frustums(rng: np.random.Generator, count: int, classes=CLASSES,
                  per_frame: int = 4) -> dict:
    """``count`` served frustums, ``per_frame`` detections a frame, drawn
    from ``rng``. Returns a dict of lists, one entry a frustum, with the
    rgb-detection pickle's keys (id, box2d, input (n, 6) float32, type,
    box2d_prob, frustum_angle, calib_K, calib_R) and the detected object's
    box in the upright camera (``center``, ``size`` as (l, w, h), full,
    ``heading``), from which the benchmark derives the label rule's
    foreground."""
    keys = ("id", "box2d", "input", "type", "box2d_prob", "frustum_angle", "calib_K",
            "calib_R", "center", "size", "heading")
    out = {k: [] for k in keys}
    frame = 0
    while len(out["id"]) < count:
        frame += 1
        sc = _frame(rng, per_frame, classes)
        pc_ud = sc["cloud"]
        pc_uc = np.zeros_like(pc_ud)
        pc_uc[:, :3] = flip_axis_to_camera(pc_ud[:, :3])
        pc_uc[:, 3:] = pc_ud[:, 3:]
        img = upright_depth_to_image(pc_ud, sc["Rtilt"], K)
        for obj in sc["objects"]:
            xmin, ymin, xmax, ymax = obj["box2d"]
            pc_in = pc_uc[(img[:, 0] >= xmin) & (img[:, 0] < xmax)
                          & (img[:, 1] >= ymin) & (img[:, 1] < ymax)]
            if len(pc_in) == 0:
                continue
            if len(pc_in) > MAX_POINTS_PER_FRUSTUM:
                pc_in = pc_in[rng.choice(len(pc_in), MAX_POINTS_PER_FRUSTUM, replace=False)]
            cx, cy = (xmin + xmax) / 2.0, (ymin + ymax) / 2.0
            ray = image_to_upright_camera(np.array([[cx, cy, 20.0]]), K, sc["Rtilt"])[0]
            out["id"].append(frame)
            out["box2d"].append(np.asarray(obj["box2d"]))
            out["input"].append(pc_in)
            out["type"].append(obj["type"])
            out["box2d_prob"].append(obj["prob"])
            out["frustum_angle"].append(float(-np.arctan2(ray[2], ray[0])))
            out["calib_K"].append(K)
            out["calib_R"].append(sc["Rtilt"])
            for k in ("center", "size", "heading"):
                out[k].append(obj[k])
    return {k: v[:count] for k, v in out.items()}
