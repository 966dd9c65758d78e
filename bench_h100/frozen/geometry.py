"""Host-side (numpy) 3D geometry the benchmark's inputs are made with.

Frozen copy of ``frustum_convnet_tpu_torch/core/geometry_np.py`` at commit
d5d2a0c (``roty``, ``rotate_pc_along_y``, ``points_in_box3d``,
``points_in_box3d_corners``, ``project_image_to_rect``), unchanged but for
this docstring. KITTI's rectified camera frame: z forward, y down, x
lateral; boxes are (center, (l, w, h), heading about y).
"""

from __future__ import annotations

import numpy as np


def roty(t: float) -> np.ndarray:
    """Rotation about the y (vertical, pointing down) axis."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotate_pc_along_y(pc: np.ndarray, rot_angle: float) -> np.ndarray:
    """Rotate XYZ[+feat] points (N, C>=3) about y by ``rot_angle`` (radians).

    x' = cos*x - sin*z ; z' = sin*x + cos*z (reference sign convention).
    Returns a copy; extra channels pass through untouched.
    """
    c, s = np.cos(rot_angle), np.sin(rot_angle)
    pc = np.array(pc, copy=True)
    x, z = pc[:, 0].copy(), pc[:, 2].copy()
    pc[:, 0] = c * x - s * z
    pc[:, 2] = s * x + c * z
    return pc


def points_in_box3d(points: np.ndarray, center, size, heading, eps: float = 0.0) -> np.ndarray:
    """Boolean mask of points (N, 3) inside the oriented box (inclusive)."""
    l, w, h = size
    local = (np.asarray(points)[:, :3] - np.asarray(center)[None, :]) @ roty(heading)
    return (
        (np.abs(local[:, 0]) <= l / 2.0 + eps)
        & (np.abs(local[:, 1]) <= h / 2.0 + eps)
        & (np.abs(local[:, 2]) <= w / 2.0 + eps)
    )


def points_in_box3d_corners(points: np.ndarray, corners: np.ndarray, eps: float = 0.0) -> np.ndarray:
    """Mask of points inside the box given its 8 corners (reference order)."""
    c = np.asarray(corners, dtype=np.float64)
    center = (c[0] + c[6]) / 2.0
    ex = c[0] - c[3]  # +l direction (x edge)
    ey = c[0] - c[4]  # +h direction (y edge)
    ez = c[0] - c[1]  # +w direction (z edge)
    dims = np.array([np.linalg.norm(ex), np.linalg.norm(ey), np.linalg.norm(ez)])
    axes = np.stack([ex, ey, ez]) / np.maximum(dims[:, None], 1e-12)  # (3,3)
    local = (np.asarray(points)[:, :3] - center[None, :]) @ axes.T
    return np.all(np.abs(local) <= dims[None, :] / 2.0 + eps, axis=1)


def project_image_to_rect(uv_depth: np.ndarray, P: np.ndarray) -> np.ndarray:
    """Back-project pixel (u, v) + rect depth to rect-camera 3D (ref formula)."""
    c_u, c_v = P[0, 2], P[1, 2]
    f_u, f_v = P[0, 0], P[1, 1]
    b_x = P[0, 3] / (-f_u)
    b_y = P[1, 3] / (-f_v)
    x = (uv_depth[:, 0] - c_u) * uv_depth[:, 2] / f_u + b_x
    y = (uv_depth[:, 1] - c_v) * uv_depth[:, 2] / f_v + b_y
    out = np.zeros_like(uv_depth, dtype=np.float64 if uv_depth.dtype == np.float64 else np.float32)
    out[:, 0] = x
    out[:, 1] = y
    out[:, 2] = uv_depth[:, 2]
    return out
