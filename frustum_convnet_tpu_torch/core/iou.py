"""Paired rotated-box IoU (BEV and 3D) in PyTorch, for the training metric.

Counterpart of ``iou_pair_3d`` and its helpers in
``frustum_convnet_tpu/core/iou.py``: the same fixed-shape candidate-vertex
formulation, with JAX's ``vmap`` over box pairs written out as a leading
batch dimension N:

1. candidates = {vertices of A inside B} + {vertices of B inside A} +
   {all 16 edge-edge intersection points}, each with a validity mask;
2. order valid candidates by angle around their centroid (a stable sort, as
   ``jnp.argsort`` is);
3. shoelace over the ordered ring -> intersection area.

``iou_matrix_bev``/``iou_matrix_3d`` serve only the device NMS, which the
port does not have, and are not ported.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _ensure_ccw(quad: torch.Tensor) -> torch.Tensor:
    """Orient quads (N, 4, 2) counter-clockwise (flip if signed area < 0)."""
    x, y = quad[..., 0], quad[..., 1]
    area2 = torch.sum(x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y, -1)
    return torch.where((area2 >= 0)[:, None, None], quad, quad.flip(-2))


def _points_in_quad(pts: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """pts (N, P, 2) inside CCW quads (N, 4, 2) -> bool (N, P). Inclusive,
    with an on-edge tolerance scaled to the cross-product terms."""
    a = quad
    b = torch.roll(quad, -1, 1)
    e = b - a  # (N, 4, 2)
    d = pts[:, :, None, :] - a[:, None, :, :]  # (N, P, 4, 2)
    t1 = e[:, None, :, 0] * d[..., 1]
    t2 = e[:, None, :, 1] * d[..., 0]
    cross = t1 - t2
    tol = 1e-5 * (t1.abs() + t2.abs() + 1.0)
    return torch.all(cross >= -tol, dim=2)


def _edge_intersections(qa: torch.Tensor, qb: torch.Tensor):
    """All 16 segment-segment intersection points between quad pairs
    (N, 4, 2). Returns (pts (N, 16, 2), valid (N, 16))."""
    p0 = torch.repeat_interleave(qa, 4, dim=1)  # (N, 16, 2) edge starts of A
    p1 = torch.repeat_interleave(torch.roll(qa, -1, 1), 4, dim=1)
    q0 = qb.repeat(1, 4, 1)
    q1 = torch.roll(qb, -1, 1).repeat(1, 4, 1)
    d1 = p1 - p0
    d2 = q1 - q0
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    dq = q0 - p0
    safe = torch.where(denom.abs() < _EPS, torch.ones_like(denom), denom)
    t = (dq[..., 0] * d2[..., 1] - dq[..., 1] * d2[..., 0]) / safe
    u = (dq[..., 0] * d1[..., 1] - dq[..., 1] * d1[..., 0]) / safe
    valid = (denom.abs() >= _EPS) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    return p0 + t[..., None] * d1, valid


def quad_intersection_area(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Intersection area of convex quad pairs (N, 4, 2) -> (N,)."""
    qa = _ensure_ccw(qa)
    qb = _ensure_ccw(qb)
    in_b = _points_in_quad(qa, qb)  # (N, 4)
    in_a = _points_in_quad(qb, qa)  # (N, 4)
    inter_pts, inter_valid = _edge_intersections(qa, qb)  # (N, 16, 2), (N, 16)

    pts = torch.cat([qa, qb, inter_pts], dim=1)  # (N, 24, 2)
    valid = torch.cat([in_b, in_a, inter_valid], dim=1)  # (N, 24)

    num = valid.sum(dim=1)  # (N,)
    centroid = (torch.where(valid[..., None], pts, torch.zeros_like(pts)).sum(1)
                / num.clamp(min=1)[:, None].to(pts.dtype))
    ang = torch.atan2(pts[..., 1] - centroid[:, None, 1],
                      pts[..., 0] - centroid[:, None, 0])
    ang = torch.where(valid, ang, torch.full_like(ang, float("inf")))
    order = torch.argsort(ang, dim=1, stable=True)  # invalid slots last
    spts = torch.gather(pts, 1, order[..., None].expand(-1, -1, 2))

    idx = torch.arange(24, device=pts.device)
    nxt = torch.where(idx[None] + 1 < num[:, None], idx[None] + 1,
                      torch.zeros_like(idx[None]))  # (N, 24)
    ring_mask = idx[None] < num[:, None]
    x, y = spts[..., 0], spts[..., 1]
    terms = x * torch.gather(y, 1, nxt) - torch.gather(x, 1, nxt) * y
    area = 0.5 * torch.where(ring_mask, terms, torch.zeros_like(terms)).sum(1).abs()
    return torch.where(num >= 3, area, torch.zeros_like(area))


def _quad_area(q: torch.Tensor) -> torch.Tensor:
    x, y = q[..., 0], q[..., 1]
    return 0.5 * torch.sum(x * torch.roll(y, -1, -1)
                           - torch.roll(x, -1, -1) * y, -1).abs()


def bev_polygon(corners3d: torch.Tensor) -> torch.Tensor:
    """(..., 8, 3) reference-order corners -> (..., 4, 2) (x, z) footprint."""
    return corners3d[..., :4, ::2]


def iou_pair_3d(corners1: torch.Tensor, corners2: torch.Tensor):
    """Paired (BEV IoU, 3D IoU) for (N, 8, 3) vs (N, 8, 3) camera-frame boxes;
    two (N,) tensors."""
    p1, p2 = bev_polygon(corners1), bev_polygon(corners2)
    inter = quad_intersection_area(p1, p2)
    a1, a2 = _quad_area(_ensure_ccw(p1)), _quad_area(_ensure_ccw(p2))
    union = a1 + a2 - inter
    zero = torch.zeros_like(inter)
    iou_bev = torch.where(union > 0, inter / union.clamp(min=_EPS), zero)

    ymin1, ymax1 = corners1[..., 1].amin(-1), corners1[..., 1].amax(-1)
    ymin2, ymax2 = corners2[..., 1].amin(-1), corners2[..., 1].amax(-1)
    y_ov = (torch.minimum(ymax1, ymax2) - torch.maximum(ymin1, ymin2)).clamp(min=0.0)
    inter3d = inter * y_ov
    union3d = a1 * (ymax1 - ymin1) + a2 * (ymax2 - ymin2) - inter3d
    iou3d = torch.where(union3d > 0, inter3d / union3d.clamp(min=_EPS), zero)
    return iou_bev, iou3d
