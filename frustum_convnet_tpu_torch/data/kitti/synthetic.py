"""Synthetic raw-KITTI scene generator (for tests and CI — no real data ships).

Writes a miniature dataset in the exact on-disk layout the prep CLI consumes:
``<root>/training/{velodyne/*.bin, calib/*.txt, label_2/*.txt, image_2/*.png}``
plus ``image_sets/{train,val}.txt`` and an rgb-detections file. Scenes contain
a ground plane plus a few cars with dense interior points so frustum
extraction finds real foreground.
"""

from __future__ import annotations

import os

import numpy as np

from frustum_convnet_tpu_torch.core import geometry_np as gnp

# A realistic KITTI P2/Tr/R0 (velo x-forward -> rect z-forward) calibration.
_P2 = np.array([
    [721.5377, 0.0, 609.5593, 44.85728],
    [0.0, 721.5377, 172.854, 0.2163791],
    [0.0, 0.0, 1.0, 0.002745884],
])
_TR = np.array([
    [7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
    [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
    [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01],
])
_R0 = np.array([
    [9.999239e-01, 9.837760e-03, -7.445048e-03],
    [-9.869795e-03, 9.999421e-01, -4.278459e-03],
    [7.402527e-03, 4.351614e-03, 9.999631e-01],
])

IMG_W, IMG_H = 1242, 375


def _calib_text() -> str:
    rows = {
        "P0": _P2, "P1": _P2, "P2": _P2, "P3": _P2,
        "R0_rect": _R0, "Tr_velo_to_cam": _TR, "Tr_imu_to_velo": _TR,
    }
    return "\n".join(f"{k}: " + " ".join(f"{v:.12e}" for v in m.flatten())
                     for k, m in rows.items()) + "\n"


_CLASS_SPECS = {
    # class -> ((l, w, h) means, (l, w, h) jitter sigmas, det-file typeid)
    "Car": ((3.9, 1.6, 1.5), (0.2, 0.1, 0.1), 2),
    "Pedestrian": ((0.8, 0.6, 1.75), (0.1, 0.05, 0.1), 1),
    "Cyclist": ((1.75, 0.6, 1.75), (0.1, 0.05, 0.1), 3),
}


# Difficulty populations for ``difficulty_mix=True``: the three KITTI
# difficulty gates (`evaluate_object_3d_offline.cpp:43-45` — MIN_HEIGHT
# {40,25,25}px, MAX_OCCLUSION {0,1,2}, MAX_TRUNCATION {.15,.3,.5}) are only
# exercised if the GT actually spans them. Each population controls depth
# (image height), surface point density, an occlusion slice (a fraction of
# the object's points removed, as a real occluder would shadow them), and a
# truncation placement at the image edge (the out-of-FOV points are then
# dropped by the prep FOV filter, `draw_util.get_lidar_in_image_fov`).
#   name: (weight, depth range, n_points, occ level, point keep frac,
#          trunc range)
_DIFFICULTY_MIX = (
    ("easy", 0.4, (8.0, 22.0), 400, 0, 1.0, (0.0, 0.0)),
    ("moderate", 0.3, (24.0, 40.0), 140, 1, 0.65, (0.16, 0.28)),
    ("hard", 0.3, (24.0, 40.0), 60, 2, 0.40, (0.32, 0.46)),
)


def make_synthetic_kitti(root: str, num_frames: int = 4, cars_per_frame: int = 2,
                         seed: int = 0, classes=("Car",),
                         difficulty_mix: bool = False) -> None:
    from PIL import Image
    from frustum_convnet_tpu_torch.data.kitti.calib import Calibration

    rng = np.random.default_rng(seed)
    split = os.path.join(root, "training")
    for d in ("velodyne", "calib", "label_2", "image_2"):
        os.makedirs(os.path.join(split, d), exist_ok=True)
    os.makedirs(os.path.join(root, "image_sets"), exist_ok=True)

    calib = Calibration({"P2": _P2, "Tr_velo_to_cam": _TR, "R0_rect": _R0})
    det_lines = []

    for idx in range(num_frames):
        labels = []
        car_clouds = []
        for _ in range(cars_per_frame):
            # draw a class only for multi-class scenes, so single-class
            # generation consumes the same rng stream as before the
            # Pedestrian/Cyclist extension
            cls = (classes[0] if len(classes) == 1
                   else classes[int(rng.integers(len(classes)))])
            means, sigmas, typeid = _CLASS_SPECS[cls]
            if difficulty_mix:
                names, weights = zip(*[(p[0], p[1]) for p in _DIFFICULTY_MIX])
                pop = _DIFFICULTY_MIX[int(rng.choice(len(names), p=weights))]
                _, _, (d0, d1), n_car, occ, keep_frac, (t0, t1) = pop
                depth = rng.uniform(d0, d1)
                trunc_goal = rng.uniform(t0, t1)
            else:
                depth = (rng.uniform(8, 35) if cls == "Car"
                         else rng.uniform(5, 20))
                n_car, occ, keep_frac, trunc_goal = 400, 0, 1.0, 0.0
            lateral = rng.uniform(-0.25, 0.25) * depth  # keep inside image FOV
            l, w, h = (m + rng.normal(0, s) for m, s in zip(means, sigmas))
            ry = rng.uniform(-np.pi, np.pi)
            bottom_y = 1.65  # camera height above road
            if difficulty_mix and trunc_goal > 0:
                # place the box so ~trunc_goal of its 2D width hangs past the
                # right image edge (left for negative draws); the FOV filter
                # then genuinely drops the out-of-image points
                probe = gnp.box3d_corners(
                    np.array([0.0, bottom_y - h / 2, depth]), (l, w, h), ry)
                uvp = calib.rect_to_image(probe)
                w_px = uvp[:, 0].max() - uvp[:, 0].min()
                side = 1.0 if rng.random() < 0.5 else -1.0
                edge = IMG_W - 1 if side > 0 else 0
                u_c = edge + side * (trunc_goal - 0.5) * w_px
                lateral = (u_c - _P2[0, 2]) * depth / _P2[0, 0]
            t = np.array([lateral, bottom_y, depth])
            center = t - np.array([0, h / 2, 0])

            # surface points on the object (in rect frame); occluded
            # populations lose a side slice, as a real occluder would
            # shadow it
            local = rng.uniform(-0.5, 0.5, (n_car, 3)) * np.array([l, h, w])
            R = gnp.roty(ry)
            pts = local @ R.T + center[None]
            if keep_frac < 1.0:
                ang = rng.uniform(0, 2 * np.pi)
                d = np.array([np.cos(ang), 0.0, np.sin(ang)])
                proj = pts @ d
                pts = pts[proj <= np.quantile(proj, keep_frac)]
            car_clouds.append(pts)

            corners = gnp.box3d_corners(center, (l, w, h), ry)
            uv = calib.rect_to_image(corners)
            fxmin, fymin = uv.min(0)
            fxmax, fymax = uv.max(0)
            xmin, xmax = np.clip([fxmin, fxmax], 0, IMG_W - 1)
            ymin, ymax = np.clip([fymin, fymax], 0, IMG_H - 1)
            if not difficulty_mix and ymax - ymin < 30:
                # keep boxes comfortably above the 25px gate
                ymax = min(IMG_H - 1, ymin + 30)
            # truncation = clipped-away fraction of the full 2D box area
            # (KITTI labels store the clipped box + this fraction)
            full_area = max((fxmax - fxmin) * (fymax - fymin), 1e-6)
            vis_area = max(xmax - xmin, 0.0) * max(ymax - ymin, 0.0)
            trunc = min(max(1.0 - vis_area / full_area, 0.0), 0.95)
            alpha = gnp.compute_alpha(t[0], t[2], ry)
            labels.append(
                f"{cls} {trunc:.2f} {occ} {alpha:.2f} {xmin:.2f} {ymin:.2f} {xmax:.2f} {ymax:.2f} "
                f"{h:.2f} {w:.2f} {l:.2f} {t[0]:.2f} {t[1]:.2f} {t[2]:.2f} {ry:.2f}"
            )
            # mimic an external 2D detector: jitter the GT box a little
            jw, jh = (xmax - xmin) * 0.05, (ymax - ymin) * 0.05
            dx1, dy1, dx2, dy2 = rng.uniform(-1, 1, 4) * [jw, jh, jw, jh]
            det_lines.append(
                f"training/image_2/{idx:06d}.png {typeid} "
                f"{rng.uniform(0.7, 0.99):.3f} "
                f"{max(0, xmin + dx1):.2f} {max(0, ymin + dy1):.2f} "
                f"{min(IMG_W - 1, xmax + dx2):.2f} {min(IMG_H - 1, ymax + dy2):.2f}"
            )

        # background: road plane + clutter, in rect frame
        n_bg = 3000
        bg = np.stack([
            rng.uniform(-20, 20, n_bg),
            np.full(n_bg, 1.65) + rng.normal(0, 0.02, n_bg),
            rng.uniform(3, 60, n_bg),
        ], axis=1)
        pc_rect = np.concatenate([bg] + car_clouds, axis=0)
        pc_velo_xyz = calib.rect_to_velo(pc_rect)
        intensity = rng.uniform(0, 1, (len(pc_velo_xyz), 1))
        pc_velo = np.hstack([pc_velo_xyz, intensity]).astype(np.float32)
        pc_velo.tofile(os.path.join(split, "velodyne", f"{idx:06d}.bin"))

        with open(os.path.join(split, "calib", f"{idx:06d}.txt"), "w") as f:
            f.write(_calib_text())
        with open(os.path.join(split, "label_2", f"{idx:06d}.txt"), "w") as f:
            f.write("\n".join(labels) + "\n")
        Image.new("RGB", (IMG_W, IMG_H), (90, 90, 90)).save(
            os.path.join(split, "image_2", f"{idx:06d}.png"))

    ids = [f"{i:06d}" for i in range(num_frames)]
    half = max(1, num_frames // 2)
    with open(os.path.join(root, "image_sets", "train.txt"), "w") as f:
        f.write("\n".join(ids[:half]) + "\n")
    with open(os.path.join(root, "image_sets", "val.txt"), "w") as f:
        f.write("\n".join(ids[half:]) + "\n")
    os.makedirs(os.path.join(root, "rgb_detections"), exist_ok=True)
    train_ids = set(range(half))
    train_lines = [ln for ln in det_lines
                   if int(os.path.basename(ln.split(" ")[0])[:6]) in train_ids]
    val_lines = [ln for ln in det_lines
                 if int(os.path.basename(ln.split(" ")[0])[:6]) not in train_ids]
    with open(os.path.join(root, "rgb_detections", "rgb_detection_train.txt"), "w") as f:
        f.write("\n".join(train_lines) + "\n")
    with open(os.path.join(root, "rgb_detections", "rgb_detection_val.txt"), "w") as f:
        f.write("\n".join(val_lines) + "\n")
