"""Depth-window point query and grouping: the plain PyTorch version.

Torch counterpart of ``frustum_convnet_tpu/ops/query_depth_point.py:35-83``
and the contract the CUDA kernel in ``csrc/group_depth_point.cu`` is held to
bit for bit. For every section center (query), scan the frustum's points in
storage order and keep the first ``nsample`` whose depth satisfies
``|z_p - z_q| < dis_z`` (strict, in the inputs' dtype). Slots past the hit
count repeat the first hit; a section with no hit selects index 0 in every
slot. The count is ``min(hits, nsample)`` as int32.

The selection is the JAX package's top-k of unique keys: ``key(n) = n`` for a
hit and ``n + N`` otherwise, so the ``nsample`` smallest keys are exactly the
first hits in storage order, and ``torch.topk(sorted=True)`` returns them
ascending. ``nsample`` may exceed N, as the reference's scan allows: the
top-k then takes all N keys, and the slots past them take the first hit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def query_depth_point(z_points: torch.Tensor, z_ref: torch.Tensor,
                      dis_z: float, nsample: int):
    """Select per-query gather indices by depth window.

    Args:
      z_points: (B, N) depth of the frustum points, in storage order.
      z_ref:    (B, M) depth of the section centers (queries).
      dis_z:    half-window; a point matches iff ``|z_p - z_q| < dis_z``.
      nsample:  slots per query (K); K > N leaves slots N.. to the first hit.

    Returns:
      idx: (B, M, K) int32 gather indices into the N axis.
      cnt: (B, M) int32 number of matches, capped at K.
    """
    n = z_points.shape[-1]
    mask = (z_points[:, None, :] - z_ref[:, :, None]).abs() < dis_z  # (B, M, N)
    arange = torch.arange(n, dtype=torch.int32, device=z_points.device)
    key = torch.where(mask, arange, arange + n)  # unique; hits sort first
    neg_sorted, _ = torch.topk(-key, min(nsample, n), dim=-1, largest=True,
                               sorted=True)
    sel = -neg_sorted  # (B, M, min(K, N)) the smallest keys, ascending
    if nsample > n:  # cnt <= N: the slots past N all take the first hit
        sel = F.pad(sel, (0, nsample - n))
    cnt = torch.clamp(mask.sum(dim=-1), max=nsample).to(torch.int32)
    first_hit = torch.where(cnt[..., None] > 0, sel[..., :1],
                            torch.zeros_like(sel[..., :1]))
    slot = torch.arange(nsample, dtype=torch.int32, device=z_points.device)
    idx = torch.where(slot < cnt[..., None], sel, first_hit)
    return idx, cnt


def group_points(points: torch.Tensor, ref: torch.Tensor, idx: torch.Tensor):
    """Gather point channels per (query, slot) and center xyz on the query.

    Args:
      points: (B, N, C) with xyz in channels 0:3 (extra channels after).
      ref:    (B, M, 3) query centers.
      idx:    (B, M, K) gather indices from :func:`query_depth_point`.

    Returns:
      (B, M, K, C) grouped features; channels 0:3 are xyz minus the center.
    """
    b = points.shape[0]
    rows = torch.arange(b, device=points.device)[:, None, None]
    grouped = points[rows, idx.long()]  # (B, M, K, C)
    centered_xyz = grouped[..., :3] - ref[:, :, None, :]
    return torch.cat([centered_xyz, grouped[..., 3:]], dim=-1)


def group_depth_point(points: torch.Tensor, ref: torch.Tensor, dis_z: float,
                      nsample: int):
    """One grouping scale: query + gather + center-subtract.

    points (B, N, C), ref (B, M, 3) -> grouped (B, M, K, C), cnt (B, M).
    """
    idx, cnt = query_depth_point(points[..., 2], ref[..., 2], dis_z, nsample)
    return group_points(points, ref, idx), cnt


def group_depth_point_multi(points: torch.Tensor, refs, dis_zs, nsamples):
    """Every grouping scale, one :func:`group_depth_point` per scale.

    points (B, N, C); refs [(B, M_i, 3)]; per-scale ``dis_zs[i]`` and
    ``nsamples[i]``. Returns ``[(grouped (B, M_i, K_i, C), cnt (B, M_i))]``.
    """
    return [group_depth_point(points, ref, d, k)
            for ref, d, k in zip(refs, dis_zs, nsamples)]
