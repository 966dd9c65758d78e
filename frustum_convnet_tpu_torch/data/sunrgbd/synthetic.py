"""Synthetic raw SUN-RGBD scene generator (tests/CI — no real data ships).

Writes the ``mysunrgbd`` layout the prep CLI consumes:
``<root>/training/{pc/%06d.npy, calib/%06d.txt, label/%06d.txt}`` plus an
``image_sets`` split. Scenes are indoor: a floor plane, clutter, and a few
furniture boxes with dense interior points; 2D boxes come from projecting
the 3D boxes through the calibration (no image files are needed anywhere on
the prep path).
"""

from __future__ import annotations

import os

import numpy as np

from frustum_convnet_tpu_torch.data.sunrgbd.calib import (SunCalibration, SunObject3d,
                                                    compute_box3d_upright_depth,
                                                    rotz)

_K = np.array([[529.5, 0.0, 365.0], [0.0, 529.5, 265.0], [0.0, 0.0, 1.0]])

CLASSES = ["bed", "chair", "table", "sofa"]
MEAN_HALF_SIZES = {
    "bed": (0.81, 1.06, 0.46),  # (w, l, h) halves
    "chair": (0.28, 0.30, 0.41),
    "table": (0.40, 0.64, 0.36),
    "sofa": (0.46, 0.93, 0.42),
}


def make_synthetic_sunrgbd(root: str, num_frames: int = 6,
                           objects_per_frame: int = 2, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    split = os.path.join(root, "training")
    for d in ("pc", "calib", "label"):
        os.makedirs(os.path.join(split, d), exist_ok=True)
    os.makedirs(os.path.join(root, "image_sets"), exist_ok=True)

    det_lines = []
    for frame in range(1, num_frames + 1):
        tilt = rng.uniform(-0.1, 0.1)
        c, s = np.cos(tilt), np.sin(tilt)
        Rtilt = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)
        calib = SunCalibration(Rtilt=Rtilt, K=_K)

        label_lines = []
        clouds = []
        for _ in range(objects_per_frame):
            cls = CLASSES[rng.integers(len(CLASSES))]
            w, l, h = (np.array(MEAN_HALF_SIZES[cls]) * rng.uniform(0.9, 1.1, 3))
            depth_fwd = rng.uniform(1.5, 5.0)  # y in upright depth
            lateral = rng.uniform(-0.3, 0.3) * depth_fwd
            centroid = np.array([lateral, depth_fwd, h])  # sits on the floor
            heading = rng.uniform(-np.pi, np.pi)
            ox, oy = np.cos(-heading), np.sin(-heading)

            # dense interior points (upright depth frame)
            n_obj = 500
            local = rng.uniform(-1, 1, (n_obj, 3)) * np.array([l, w, h])
            pts = (rotz(-heading) @ local.T).T + centroid[None]
            clouds.append(pts)

            line = (f"{cls} 0 0 0 0 "
                    f"{centroid[0]:.4f} {centroid[1]:.4f} {centroid[2]:.4f} "
                    f"{w:.4f} {l:.4f} {h:.4f} 1 0 0 1 {ox:.4f} {oy:.4f}")
            obj = SunObject3d(line)
            corners = compute_box3d_upright_depth(obj)
            uv, _ = calib.upright_depth_to_image(corners)
            xmin, ymin = uv.min(0)
            xmax, ymax = uv.max(0)
            obj.xmin, obj.ymin, obj.xmax, obj.ymax = xmin, ymin, xmax, ymax
            label_lines.append(obj.to_label_line())
            det_lines.append(f"{frame} {cls} {rng.uniform(0.6, 0.95):.3f} "
                             f"{xmin:.2f} {ymin:.2f} {xmax:.2f} {ymax:.2f}")

        n_bg = 4000
        floor = np.stack([
            rng.uniform(-4, 4, n_bg),
            rng.uniform(0.5, 8.0, n_bg),
            np.zeros(n_bg) + rng.normal(0, 0.01, n_bg),
        ], axis=1)
        pc = np.concatenate([floor] + clouds, axis=0)
        rgb = rng.uniform(0, 1, (len(pc), 3))
        np.save(os.path.join(split, "pc", f"{frame:06d}.npy"),
                np.hstack([pc, rgb]).astype(np.float32))
        with open(os.path.join(split, "calib", f"{frame:06d}.txt"), "w") as f:
            f.write(calib.calib_text())
        with open(os.path.join(split, "label", f"{frame:06d}.txt"), "w") as f:
            f.write("\n".join(label_lines) + "\n")

    ids = [f"{i:06d}" for i in range(1, num_frames + 1)]
    half = max(1, num_frames // 2)
    with open(os.path.join(root, "image_sets", "train.txt"), "w") as f:
        f.write("\n".join(ids[:half]) + "\n")
    with open(os.path.join(root, "image_sets", "val.txt"), "w") as f:
        f.write("\n".join(ids[half:]) + "\n")
    with open(os.path.join(root, "det_val.txt"), "w") as f:
        f.write("\n".join(det_lines) + "\n")
