"""Host-side (numpy) 3D geometry for the frustum pipeline.

Coordinate convention is the KITTI rectified-camera frame used throughout the
reference (`datasets/data_utils.py`): z forward, y down,
x lateral. Boxes are (center, (l, w, h), heading-about-y).

Every function here has a jax twin in :mod:`frustum_convnet_tpu.core.geometry`;
the numpy versions drive the host data pipeline and serve as test oracles.

Behavioral contracts replicated from the reference:
* ``rotate_pc_along_y`` — ref `datasets/data_utils.py:7-21`.
* ``box3d_corners`` — ref `datasets/data_utils.py:44-70` and
  `models/model_util.py:48-72` (identical corner ordering).
* ``project_image_to_rect`` — ref `datasets/data_utils.py:73-93`.
* ``points_in_box3d`` replaces the reference's scipy-Delaunay ``in_hull``
  (`datasets/data_utils.py:24-34`) with an oriented-box half-space test —
  equivalent for these convex boxes and jit-able on device.
"""

from __future__ import annotations

import numpy as np


def rotx(t: float) -> np.ndarray:
    """Rotation about the x axis (ref `kitti_util.py:241-248`)."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty(t: float) -> np.ndarray:
    """Rotation about the y (vertical, pointing down) axis."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz(t: float) -> np.ndarray:
    """Rotation about the z axis (ref `kitti_util.py:259-266`)."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


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


def box3d_corners(center, size, heading) -> np.ndarray:
    """8 corners (8, 3) of a 3D box; size = (l, w, h), heading about y.

    Corner order matches the reference: indices 0-3 are the y=+h/2 (bottom,
    y points down) face, 4-7 the y=-h/2 face; x alternates +l/2, +l/2, -l/2,
    -l/2 and z +w/2, -w/2, -w/2, +w/2.
    """
    l, w, h = size
    x = np.array([l, l, -l, -l, l, l, -l, -l]) / 2.0
    y = np.array([h, h, h, h, -h, -h, -h, -h]) / 2.0
    z = np.array([w, -w, -w, w, w, -w, -w, w]) / 2.0
    corners = roty(heading) @ np.stack([x, y, z])  # (3, 8)
    return corners.T + np.asarray(center)[None, :]


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
    """Mask of points inside the box given its 8 corners (reference order).

    Reconstructs the oriented frame from the corner layout of
    :func:`box3d_corners`, so it accepts any box produced in that order.
    """
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


def project_rect_to_image(pts_3d_rect: np.ndarray, P: np.ndarray) -> np.ndarray:
    """Project rect-camera 3D points (N, 3) to image pixels (N, 2)."""
    n = pts_3d_rect.shape[0]
    hom = np.hstack([pts_3d_rect, np.ones((n, 1))])
    uvw = hom @ P.T
    return uvw[:, :2] / uvw[:, 2:3]


def compute_alpha(x, z, ry):
    """Observation angle alpha from location + yaw (ref provider_sample.py:389-394)."""
    beta = np.arctan2(z, x)
    return -np.sign(beta) * np.pi / 2 + beta + ry
