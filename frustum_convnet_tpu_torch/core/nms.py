"""Greedy non-maximum suppression for axis-aligned / BEV-rotated / 3D boxes.

Host-side numpy implementations matching the behavior of the reference's
C++ suppression ops and their numpy glue
(reference `ops/pybind11/nms_cpu.h:28-240`,
`ops/pybind11/rbbox_iou.py:203-311`): descending-score order, suppress when
overlap > thresh, keep capped at ``top_k``. Box parameterizations follow the
reference entry points:

* ``rotate_nms_bev``: dets (N, 6) = (cx, cz, l, w, ry, score)
* ``rotate_nms_3d``:  dets (N, 8) = (cx, cy, cz, l, w, h, ry, score) where the
  y span is treated as cy ± h/2 (`ops/pybind11/rbbox_iou.py:121-149`; the
  test driver passes KITTI bottom-anchored ty for cy — consistently for all
  candidates, so suppression behavior is identical).

Per-frustum candidate counts are tiny (≤ a few hundred), so exact polygon
IoU on host is fast; a device-side fixed-size variant lives in
:mod:`frustum_convnet_tpu.ops.nms_jax` for fully-fused streaming inference.
"""

from __future__ import annotations

import numpy as np

from frustum_convnet_tpu_torch.core import geometry_np as gnp
from frustum_convnet_tpu_torch.core import iou_np


def nms_axis_aligned(boxes: np.ndarray, scores: np.ndarray, thresh: float,
                     top_k: int = 300) -> list[int]:
    """Plain 2D NMS; boxes (N, 4) xyxy."""
    order = np.argsort(scores)[::-1]
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = []
    while order.size > 0 and len(keep) < top_k:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-12)
        order = rest[iou <= thresh]
    return keep


def _bev_corners(cx, cz, l, w, ry) -> np.ndarray:
    """(4, 2) BEV footprint in the (x, z) plane for heading ry about y."""
    x = np.array([l, l, -l, -l]) / 2.0
    z = np.array([w, -w, -w, w]) / 2.0
    c, s = np.cos(ry), np.sin(ry)
    return np.stack([c * x + s * z + cx, -s * x + c * z + cz], axis=1)


def rotate_nms_bev(dets: np.ndarray, thresh: float, top_k: int = 300) -> list[int]:
    """BEV rotated NMS; dets (N, 6) = (cx, cz, l, w, ry, score)."""
    if len(dets) == 0:
        return []
    order = np.argsort(dets[:, 5])[::-1]
    polys = [
        _bev_corners(*dets[i, :5]) for i in range(len(dets))
    ]
    keep = []
    while order.size > 0 and len(keep) < top_k:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        ious = np.array([iou_np.rotated_iou_bev_np(polys[i], polys[j]) for j in rest])
        order = rest[ious <= thresh]
    return keep


def rotate_nms_3d(dets: np.ndarray, thresh: float, top_k: int = 300) -> list[int]:
    """3D rotated NMS; dets (N, 8) = (cx, cy, cz, l, w, h, ry, score)."""
    if len(dets) == 0:
        return []
    order = np.argsort(dets[:, 7])[::-1]
    corners = [
        gnp.box3d_corners(dets[i, :3], dets[i, 3:6], dets[i, 6]) for i in range(len(dets))
    ]
    keep = []
    while order.size > 0 and len(keep) < top_k:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        ious = np.array(
            [iou_np.rotated_iou_3d_np(corners[i], corners[j])[1] for j in rest]
        )
        order = rest[ious <= thresh]
    return keep


# reference-compatible aliases (cube_nms / bev_nms entry-point names)
cube_nms = rotate_nms_3d
bev_nms = rotate_nms_bev
