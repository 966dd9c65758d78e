"""Fixed-size greedy rotated NMS on the device.

Counterpart of ``frustum_convnet_tpu/ops/nms_jax.py``: a precomputed (N, N)
rotated 3D IoU matrix (``core/iou.iou_matrix_3d``), then ``max_out`` greedy
picks over an alive mask. Every pick is a handful of tensor operations on the
scores' device, with no value read back to the host inside the loop (the
JAX ``fori_loop``), so the loop only enqueues work. The serving drivers keep
the host NMS (``ops/native.rotate_nms_3d``); this is the device twin that
the JAX package offers beside it.
"""

from __future__ import annotations

import torch

from frustum_convnet_tpu_torch.core.geometry import box3d_corners
from frustum_convnet_tpu_torch.core.iou import iou_matrix_3d

NEG = -1e30


def greedy_nms_from_iou(iou: torch.Tensor, scores: torch.Tensor,
                        valid: torch.Tensor, thresh: float, max_out: int):
    """Greedy suppression given a precomputed IoU matrix.

    Args: iou (N, N); scores (N,); valid (N,) bool, the candidates to
    consider. Each pick takes the highest alive score (the first index on a
    tie, as ``jnp.argmax``) and suppresses itself and every box whose IoU
    with it exceeds ``thresh``. Returns (keep (max_out,) int32 padded with
    -1, keep count, a 0-d tensor), both on the scores' device.
    """
    n = scores.shape[0]
    ar = torch.arange(n, device=scores.device)
    alive = valid.clone()
    keep = torch.full((max_out,), -1, dtype=torch.int32, device=scores.device)
    for i in range(max_out):
        masked = torch.where(alive, scores, NEG)
        j = torch.argmax(masked).reshape(1)
        ok = masked.gather(0, j) > NEG  # (1,)
        keep[i:i + 1] = torch.where(ok, j, -1)
        suppress = (iou.index_select(0, j)[0] > thresh) | (ar == j)
        alive = alive & ~(suppress & ok)
    return keep, (keep >= 0).sum()


def rotate_nms_3d_device(centers: torch.Tensor, sizes: torch.Tensor,
                         headings: torch.Tensor, scores: torch.Tensor,
                         valid: torch.Tensor, thresh: float, max_out: int):
    """3D rotated NMS from box parameters, entirely on the boxes' device.

    centers (N, 3), sizes (N, 3 lwh), headings (N,), scores (N,), valid (N,)
    bool. Returns (keep (max_out,) int32 padded with -1, keep count).
    """
    corners = box3d_corners(centers, headings, sizes)
    iou = iou_matrix_3d(corners, corners)
    return greedy_nms_from_iou(iou, scores, valid, thresh, max_out)
