"""KITTI calibration and label-file access.

Fresh implementation of the standard KITTI transforms covered by the
reference's `kitti/kitti_util.py:62-298` (Calibration with P2 /
Tr_velo_to_cam / R0_rect and the projection chain velo -> ref -> rect ->
image, label parse/write incl. optional score).

Coordinate frames:
  velo: x forward, y left, z up              (LiDAR)
  ref:  x right, y down, z forward           (camera 0, unrectified)
  rect: ref after R0_rect                    (all 3D boxes live here)
  image: pixels via P2
"""

from __future__ import annotations

import os

import numpy as np


class Object3d:
    """One KITTI label line (type trunc occ alpha box2d hwl t ry [score])."""

    def __init__(self, line: str):
        parts = line.strip().split(" ")
        self.type = parts[0]
        vals = [float(x) for x in parts[1:]]
        self.truncation = vals[0]
        self.occlusion = int(vals[1])
        self.alpha = vals[2]
        self.xmin, self.ymin, self.xmax, self.ymax = vals[3:7]
        self.box2d = np.array([self.xmin, self.ymin, self.xmax, self.ymax])
        self.h, self.w, self.l = vals[7:10]
        self.t = tuple(vals[10:13])  # bottom-center of box, rect frame
        self.ry = vals[13]
        self.score = vals[14] if len(vals) > 14 else None

    def to_kitti_line(self) -> str:
        fields = [
            self.type,
            f"{self.truncation:.2f}",
            str(int(self.occlusion)),
            f"{self.alpha:.2f}",
            f"{self.xmin:.2f}", f"{self.ymin:.2f}", f"{self.xmax:.2f}", f"{self.ymax:.2f}",
            f"{self.h:.2f}", f"{self.w:.2f}", f"{self.l:.2f}",
            f"{self.t[0]:.2f}", f"{self.t[1]:.2f}", f"{self.t[2]:.2f}",
            f"{self.ry:.2f}",
        ]
        if self.score is not None:
            fields.append(f"{self.score:.2f}")
        return " ".join(fields)


def read_label(path: str):
    with open(path) as f:
        return [Object3d(line) for line in f if line.strip()]


def load_velo_scan(path: str) -> np.ndarray:
    """KITTI .bin velodyne scan -> (N, 4) float32 (x, y, z, intensity)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def _inverse_rigid(T: np.ndarray) -> np.ndarray:
    """Invert a 3x4 [R|t] rigid transform."""
    inv = np.zeros_like(T)
    inv[:3, :3] = T[:3, :3].T
    inv[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return inv


class Calibration:
    """KITTI calib file wrapper with the full projection chain."""

    def __init__(self, calib_path_or_dict):
        if isinstance(calib_path_or_dict, dict):
            d = calib_path_or_dict
        else:
            d = self._read_calib_file(calib_path_or_dict)
        self.P = np.asarray(d["P2"], dtype=np.float64).reshape(3, 4)
        self.V2C = np.asarray(d["Tr_velo_to_cam"], dtype=np.float64).reshape(3, 4)
        self.C2V = _inverse_rigid(self.V2C)
        self.R0 = np.asarray(d["R0_rect"], dtype=np.float64).reshape(3, 3)
        self.c_u = self.P[0, 2]
        self.c_v = self.P[1, 2]
        self.f_u = self.P[0, 0]
        self.f_v = self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)

    @classmethod
    def from_video(cls, calib_dir: str) -> "Calibration":
        """Build from a KITTI raw-video calib directory.

        Reads ``calib_cam_to_cam.txt`` (R_rect_00, P_rect_02) and
        ``calib_velo_to_cam.txt`` (R, T) — the video-calib convention of
        reference `kitti/kitti_util.py:146-160`.
        """
        cam2cam = cls._read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
        velo2cam = cls._read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))
        v2c = np.zeros((3, 4))
        v2c[:3, :3] = np.asarray(velo2cam["R"]).reshape(3, 3)
        v2c[:, 3] = np.asarray(velo2cam["T"]).reshape(3)
        return cls({"P2": cam2cam["P_rect_02"],
                    "Tr_velo_to_cam": v2c,
                    "R0_rect": cam2cam["R_rect_00"]})

    @staticmethod
    def _read_calib_file(path: str) -> dict:
        data = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or ":" not in line:
                    continue
                key, val = line.split(":", 1)
                try:
                    data[key.strip()] = np.array([float(x) for x in val.split()])
                except ValueError:
                    continue
        # tolerate the alternate key name used in some dumps
        if "R0_rect" not in data and "R_rect" in data:
            data["R0_rect"] = data["R_rect"]
        return data

    def as_dict(self) -> dict:
        """Plain-array dict for pickling alongside frustum records."""
        return {"P2": self.P.copy(), "Tr_velo_to_cam": self.V2C.copy(),
                "R0_rect": self.R0.copy()}

    # --- homogeneous helper
    @staticmethod
    def _hom(pts: np.ndarray) -> np.ndarray:
        return np.hstack([pts, np.ones((pts.shape[0], 1))])

    # --- velo <-> ref
    def velo_to_ref(self, pts: np.ndarray) -> np.ndarray:
        return self._hom(pts) @ self.V2C.T

    def ref_to_velo(self, pts: np.ndarray) -> np.ndarray:
        return self._hom(pts) @ self.C2V.T

    # --- ref <-> rect
    def ref_to_rect(self, pts: np.ndarray) -> np.ndarray:
        return pts @ self.R0.T

    def rect_to_ref(self, pts: np.ndarray) -> np.ndarray:
        return pts @ np.linalg.inv(self.R0).T

    # --- compositions
    def velo_to_rect(self, pts: np.ndarray) -> np.ndarray:
        return self.ref_to_rect(self.velo_to_ref(pts))

    def rect_to_velo(self, pts: np.ndarray) -> np.ndarray:
        return self.ref_to_velo(self.rect_to_ref(pts))

    # --- rect <-> image
    def rect_to_image(self, pts: np.ndarray) -> np.ndarray:
        uvw = self._hom(pts) @ self.P.T
        return uvw[:, :2] / uvw[:, 2:3]

    def velo_to_image(self, pts: np.ndarray) -> np.ndarray:
        return self.rect_to_image(self.velo_to_rect(pts))

    def image_to_rect(self, uv_depth: np.ndarray) -> np.ndarray:
        """(u, v, rect-depth) -> rect xyz (reference back-projection formula)."""
        x = (uv_depth[:, 0] - self.c_u) * uv_depth[:, 2] / self.f_u + self.b_x
        y = (uv_depth[:, 1] - self.c_v) * uv_depth[:, 2] / self.f_v + self.b_y
        return np.stack([x, y, uv_depth[:, 2]], axis=1)

    def image_to_velo(self, uv_depth: np.ndarray) -> np.ndarray:
        """(u, v, rect-depth) -> velodyne xyz (ref `kitti_util.py:236-238`)."""
        return self.rect_to_velo(self.image_to_rect(uv_depth))
