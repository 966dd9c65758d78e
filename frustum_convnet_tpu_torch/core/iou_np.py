"""Numpy oracle for rotated-box IoU, via Sutherland-Hodgman polygon clipping.

Independent slow-path implementation used to validate the vectorized JAX IoU
(:mod:`frustum_convnet_tpu.core.iou`) and the native C++ ops. Plays the role of
the reference's "slow, not recommend" `utils/box_util.py:93-150` oracle.
"""

from __future__ import annotations

import numpy as np


def _cross2(a: np.ndarray, b: np.ndarray) -> float:
    """2D scalar cross product (np.cross on 2-vectors is deprecated)."""
    return float(a[0] * b[1] - a[1] * b[0])


def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _ensure_ccw(poly: np.ndarray) -> np.ndarray:
    return poly if _signed_area(poly) >= 0 else poly[::-1]


def clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Clip a convex polygon by a convex CCW polygon (Sutherland-Hodgman)."""
    clip = _ensure_ccw(np.asarray(clip, dtype=np.float64))
    output = list(_ensure_ccw(np.asarray(subject, dtype=np.float64)))
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        edge = b - a
        input_list, output = output, []
        if not input_list:
            break
        for j, cur in enumerate(input_list):
            prv = input_list[j - 1]
            cur_in = _cross2(edge, cur - a) >= 0
            prv_in = _cross2(edge, prv - a) >= 0
            if cur_in:
                if not prv_in:
                    output.append(_seg_line_intersect(prv, cur, a, b))
                output.append(cur)
            elif prv_in:
                output.append(_seg_line_intersect(prv, cur, a, b))
    return np.array(output) if output else np.zeros((0, 2))


def _seg_line_intersect(p0, p1, a, b):
    d = p1 - p0
    e = b - a
    denom = _cross2(e, d)
    if abs(denom) < 1e-14:
        return p1
    t = _cross2(e, a - p0) / denom
    return p0 + t * d


def polygon_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    return abs(_signed_area(poly))


def rotated_iou_bev_np(poly1: np.ndarray, poly2: np.ndarray) -> float:
    """IoU of two convex polygons (V, 2)."""
    inter = polygon_area(clip_polygon(poly1, poly2))
    a1, a2 = polygon_area(_ensure_ccw(poly1)), polygon_area(_ensure_ccw(poly2))
    union = a1 + a2 - inter
    return inter / union if union > 0 else 0.0


def box_bev_polygon(corners3d: np.ndarray) -> np.ndarray:
    """(x, z) footprint polygon of a 3D box given 8 corners (reference order)."""
    return corners3d[:4][:, [0, 2]]


def rotated_iou_3d_np(corners1: np.ndarray, corners2: np.ndarray):
    """(BEV IoU, 3D IoU) for two boxes given 8 corners each (reference order).

    Mirrors the quantities of the reference's `ops/pybind11/box_ops.h:173-260`
    per-pair metric: camera-frame boxes, y is the vertical axis.
    """
    p1, p2 = box_bev_polygon(corners1), box_bev_polygon(corners2)
    inter_area = polygon_area(clip_polygon(p1, p2))
    a1, a2 = polygon_area(_ensure_ccw(p1)), polygon_area(_ensure_ccw(p2))
    iou_bev = inter_area / (a1 + a2 - inter_area) if a1 + a2 - inter_area > 0 else 0.0

    ymin1, ymax1 = corners1[:, 1].min(), corners1[:, 1].max()
    ymin2, ymax2 = corners2[:, 1].min(), corners2[:, 1].max()
    y_overlap = max(0.0, min(ymax1, ymax2) - max(ymin1, ymin2))
    inter3d = inter_area * y_overlap
    v1 = a1 * (ymax1 - ymin1)
    v2 = a2 * (ymax2 - ymin2)
    union3d = v1 + v2 - inter3d
    iou3d = inter3d / union3d if union3d > 0 else 0.0
    return iou_bev, iou3d
