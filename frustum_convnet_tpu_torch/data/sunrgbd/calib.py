"""SUN-RGBD calibration, labels, and coordinate transforms.

Fresh implementation of the conventions in
reference `sunrgbd/sunrgbd_utils.py:16-268`. Coordinate systems:

* camera:         x right, y down, z forward
* depth:          x right, y forward, z up (axis swap + flip of camera)
* upright depth:  depth tilted by Rtilt so z is the gravity direction;
                  depth points and 3D labels are stored here
* upright camera: axis swap + flip of upright depth — frustum points and
                  boxes are generated here (same convention as KITTI rect,
                  so the shared model geometry applies unchanged)

Label lines: ``classname xmin ymin w h cx cy cz hw hl hh b11 b12 b21 b22
ox oy`` with HALF-sizes (w, l, h) and orientation vector (ox, oy);
heading = -atan2(oy, ox).
"""

from __future__ import annotations

import os

import numpy as np


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


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


class SunObject3d:
    def __init__(self, line: str):
        parts = line.split(" ")
        vals = [float(x) for x in parts[1:]]
        self.classname = parts[0]
        self.xmin, self.ymin = vals[0], vals[1]
        self.xmax, self.ymax = vals[0] + vals[2], vals[1] + vals[3]
        self.box2d = np.array([self.xmin, self.ymin, self.xmax, self.ymax])
        self.centroid = np.array(vals[4:7])
        self.w, self.l, self.h = vals[7], vals[8], vals[9]  # HALF sizes
        self.orientation = np.array([vals[14], vals[15], 0.0])
        self.heading_angle = -np.arctan2(self.orientation[1], self.orientation[0])

    def to_label_line(self) -> str:
        ox, oy = np.cos(-self.heading_angle), np.sin(-self.heading_angle)
        return (f"{self.classname} {self.xmin:.2f} {self.ymin:.2f} "
                f"{self.xmax - self.xmin:.2f} {self.ymax - self.ymin:.2f} "
                f"{self.centroid[0]:.4f} {self.centroid[1]:.4f} {self.centroid[2]:.4f} "
                f"{self.w:.4f} {self.l:.4f} {self.h:.4f} "
                f"1 0 0 1 {ox:.4f} {oy:.4f}")


def read_sunrgbd_label(path: str):
    with open(path) as f:
        return [SunObject3d(line) for line in f if line.strip()]


class SunCalibration:
    """Rtilt + K calibration with the five-coordinate-system transforms."""

    def __init__(self, calib_path: str | None = None, Rtilt=None, K=None):
        if calib_path is not None:
            lines = [line.rstrip() for line in open(calib_path)]
            # column-major ('F') flattening, as the toolbox dumps them
            self.Rtilt = np.array([float(x) for x in lines[0].split(" ")]).reshape(3, 3, order="F")
            self.K = np.array([float(x) for x in lines[1].split(" ")]).reshape(3, 3, order="F")
        else:
            self.Rtilt = np.asarray(Rtilt, dtype=np.float64)
            self.K = np.asarray(K, dtype=np.float64)
        self.f_u, self.f_v = self.K[0, 0], self.K[1, 1]
        self.c_u, self.c_v = self.K[0, 2], self.K[1, 2]

    def calib_text(self) -> str:
        return (" ".join(f"{v:.12g}" for v in self.Rtilt.flatten(order="F")) + "\n"
                + " ".join(f"{v:.12g}" for v in self.K.flatten(order="F")) + "\n")

    # --- upright depth <-> camera/image
    def upright_depth_to_camera(self, pc: np.ndarray) -> np.ndarray:
        return flip_axis_to_camera((self.Rtilt.T @ pc[:, :3].T).T)

    def upright_depth_to_image(self, pc: np.ndarray):
        cam = self.upright_depth_to_camera(pc)
        uv = cam @ self.K.T
        return uv[:, :2] / uv[:, 2:3], cam[:, 2]

    def upright_depth_to_upright_camera(self, pc: np.ndarray) -> np.ndarray:
        return flip_axis_to_camera(pc)

    def upright_camera_to_upright_depth(self, pc: np.ndarray) -> np.ndarray:
        return flip_axis_to_depth(pc)

    def image_to_camera(self, uv_depth: np.ndarray) -> np.ndarray:
        x = (uv_depth[:, 0] - self.c_u) * uv_depth[:, 2] / self.f_u
        y = (uv_depth[:, 1] - self.c_v) * uv_depth[:, 2] / self.f_v
        return np.stack([x, y, uv_depth[:, 2]], axis=1)

    def image_to_upright_camera(self, uv_depth: np.ndarray) -> np.ndarray:
        depth = flip_axis_to_depth(self.image_to_camera(uv_depth))
        upright_depth = (self.Rtilt @ depth.T).T
        return self.upright_depth_to_upright_camera(upright_depth)


def project_image_to_upright_camera(uv_depth: np.ndarray, K: np.ndarray,
                                    Rtilt: np.ndarray) -> np.ndarray:
    """Standalone variant used by the provider (pickles carry K/Rtilt arrays)."""
    return SunCalibration(Rtilt=Rtilt, K=K).image_to_upright_camera(uv_depth)


def compute_box3d_upright_depth(obj: SunObject3d) -> np.ndarray:
    """8 corners in upright depth coords (ref sunrgbd_utils.py:237-268).

    Half-size corner offsets rotated by rotz(-heading), centroid-anchored.
    """
    R = rotz(-obj.heading_angle)
    l, w, h = obj.l, obj.w, obj.h  # half sizes
    x = np.array([-l, l, l, -l, -l, l, l, -l])
    y = np.array([w, w, -w, -w, w, w, -w, -w])
    z = np.array([h, h, h, h, -h, -h, -h, -h])
    corners = (R @ np.stack([x, y, z])).T
    return corners + obj.centroid[None, :]


def load_depth_points(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[-1]
    if ext == ".npy":
        return np.load(path)
    if ext == ".mat":
        import scipy.io as sio
        return sio.loadmat(path, verify_compressed_data_integrity=False)["x"].astype(np.float32)
    if ext == ".txt":
        return np.loadtxt(path)
    raise ValueError(f"unknown point file format {path}")


def random_shift_box2d(box2d, shift_ratio=0.1, rng=None):
    """2D box jitter (no image clipping, ref sunrgbd_utils.py:208-221)."""
    rng = rng or np.random.default_rng()
    r = shift_ratio
    xmin, ymin, xmax, ymax = box2d
    w, h = xmax - xmin, ymax - ymin
    cx = (xmin + xmax) / 2.0 + w * r * rng.uniform(-1, 1)
    cy = (ymin + ymax) / 2.0 + h * r * rng.uniform(-1, 1)
    w2 = w * (1 + rng.uniform(-r, r))
    h2 = h * (1 + rng.uniform(-r, r))
    return np.array([cx - w2 / 2, cy - h2 / 2, cx + w2 / 2, cy + h2 / 2])


def read_3d_points(rgb_path: str, depth_path: str, Rtilt, K) -> np.ndarray:
    """Depth+RGB images -> (N, 6) upright-depth points (toolbox read3dPoints).

    Depth decode: 16-bit value bit-rotated by 3 ((d>>3)|(d<<13)), mm -> m,
    clipped to 8 m (ref `sunrgbd/read_3d_points.py:4-36`).
    """
    from PIL import Image

    depth_vis = np.asarray(Image.open(depth_path), dtype=np.uint16)
    valid = (depth_vis != 0).ravel()
    depth = ((depth_vis >> 3) | (depth_vis << 13)).astype(np.float32) / 1000.0
    depth = np.minimum(depth, 8.0)
    h, w = depth.shape
    K = np.asarray(K)
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    x3 = (x - K[0, 2]) * depth / K[0, 0]
    y3 = (y - K[1, 2]) * depth / K[1, 1]
    pts = np.stack([x3.ravel(), depth.ravel(), -y3.ravel()], axis=1)[valid]
    pts = (np.asarray(Rtilt) @ pts.T).T
    rgb = np.asarray(Image.open(rgb_path), dtype=np.float32).reshape(-1, 3)[valid] / 255.0
    return np.concatenate([pts, rgb], axis=1)
