"""Broadcast box-overlap utilities and parameterization converters.

Covers the general-purpose numpy helper API of the reference's
reference `ops/pybind11/rbbox_iou.py:6-155` (axis-aligned overlap
matrices in 1/2/3 dimensions, rotated-box -> corner conversion, stand-up
envelopes) — used by NMS pre-gating and the prep pipelines. Fresh
implementations.
"""

from __future__ import annotations

import numpy as np

from frustum_convnet_tpu_torch.core import geometry_np as gnp


def bbox_overlaps_1d(ex: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(N, 2) x (K, 2) interval IoU matrix."""
    lo = np.maximum(ex[:, None, 0], gt[None, :, 0])
    hi = np.minimum(ex[:, None, 1], gt[None, :, 1])
    inter = np.maximum(hi - lo, 0.0)
    len_ex = (ex[:, 1] - ex[:, 0])[:, None]
    len_gt = (gt[:, 1] - gt[:, 0])[None, :]
    union = len_ex + len_gt - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def bbox_overlaps_2d(ex: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(N, 4) x (K, 4) xyxy IoU matrix."""
    x1 = np.maximum(ex[:, None, 0], gt[None, :, 0])
    y1 = np.maximum(ex[:, None, 1], gt[None, :, 1])
    x2 = np.minimum(ex[:, None, 2], gt[None, :, 2])
    y2 = np.minimum(ex[:, None, 3], gt[None, :, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    a_ex = ((ex[:, 2] - ex[:, 0]) * (ex[:, 3] - ex[:, 1]))[:, None]
    a_gt = ((gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]))[None, :]
    union = a_ex + a_gt - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def bbox_overlaps_3d(ex: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(N, 6) x (K, 6) (xmin ymin zmin xmax ymax zmax) IoU matrix."""
    lo = np.maximum(ex[:, None, :3], gt[None, :, :3])
    hi = np.minimum(ex[:, None, 3:], gt[None, :, 3:])
    inter = np.prod(np.maximum(hi - lo, 0.0), axis=-1)
    v_ex = np.prod(ex[:, 3:] - ex[:, :3], axis=-1)[:, None]
    v_gt = np.prod(gt[:, 3:] - gt[:, :3], axis=-1)[None, :]
    union = v_ex + v_gt - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def rbbox2corner(boxes_2d: np.ndarray) -> np.ndarray:
    """(N, 5) (cx, cz, l, w, ry) -> BEV corner polygons (N, 4, 2)."""
    l, w, r = boxes_2d[:, 2], boxes_2d[:, 3], boxes_2d[:, 4]
    sx = np.array([1.0, 1.0, -1.0, -1.0])
    sz = np.array([1.0, -1.0, -1.0, 1.0])
    x = 0.5 * l[:, None] * sx[None, :]
    z = 0.5 * w[:, None] * sz[None, :]
    c, s = np.cos(r)[:, None], np.sin(r)[:, None]
    return np.stack([c * x + s * z + boxes_2d[:, 0:1],
                     -s * x + c * z + boxes_2d[:, 1:2]], axis=-1)


def boxes3d2corners(boxes_3d: np.ndarray) -> np.ndarray:
    """(N, >=7) (cx, cy, cz, l, w, h, ry, ...) -> corners (N, 8, 3)."""
    return np.stack([
        gnp.box3d_corners(b[:3], b[3:6], b[6]) for b in boxes_3d
    ])


def corner2standup(corners: np.ndarray) -> np.ndarray:
    """(N, V, D) corner sets -> axis-aligned envelopes (N, 2*D) (mins, maxs)."""
    return np.concatenate([corners.min(axis=1), corners.max(axis=1)], axis=1)


def rbbox_iou(boxes_2d: np.ndarray, qboxes_2d: np.ndarray,
              standup_thresh: float = 0.0) -> np.ndarray:
    """(N, 5) x (K, 5) rotated BEV IoU matrix with stand-up pre-gate."""
    from frustum_convnet_tpu_torch.core.iou_np import rotated_iou_bev_np

    pc = rbbox2corner(boxes_2d)
    qc = rbbox2corner(qboxes_2d)
    gate = bbox_overlaps_2d(corner2standup(pc), corner2standup(qc)) > standup_thresh
    out = np.zeros((len(pc), len(qc)))
    for i in range(len(pc)):
        for j in range(len(qc)):
            if gate[i, j]:
                out[i, j] = rotated_iou_bev_np(pc[i], qc[j])
    return out


def rbbox_iou_3d(boxes_3d: np.ndarray, qboxes_3d: np.ndarray,
                 standup_thresh: float = 0.0) -> np.ndarray:
    """(N, 7) x (K, 7) rotated 3D IoU matrix (param form, center-anchored)."""
    from frustum_convnet_tpu_torch.ops.native import rbbox_iou_3d_matrix

    return rbbox_iou_3d_matrix(boxes3d2corners(boxes_3d), boxes3d2corners(qboxes_3d))


def rbbox_iou_3d_pair(corners: np.ndarray, qcorners: np.ndarray) -> np.ndarray:
    """Paired (BEV, 3D) IoU on (N, 8, 3) corner boxes (ref training metric)."""
    from frustum_convnet_tpu_torch.ops.native import rbbox_iou_3d_pair as native_pair

    return native_pair(corners, qcorners)
