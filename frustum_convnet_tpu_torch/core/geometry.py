"""3D geometry in PyTorch: batched, differentiable twins of ``geometry_np``.

Counterpart of ``frustum_convnet_tpu/core/geometry.py`` (same functions,
argument order, sign conventions and operation order), so float32 inputs
give the JAX results up to the backends' rounding of ``cos``/``sin``.
"""

from __future__ import annotations

import torch


def rotate_points_along_y(pc: torch.Tensor, rot_angle: torch.Tensor) -> torch.Tensor:
    """Rotate points (..., N, C>=3) about y by per-batch angles (...,).

    x' = cos*x - sin*z ; z' = sin*x + cos*z (reference sign convention,
    `datasets/data_utils.py:7-21`).
    """
    c = torch.cos(rot_angle)[..., None]
    s = torch.sin(rot_angle)[..., None]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    return torch.cat([(c * x - s * z)[..., None], y[..., None],
                      (s * x + c * z)[..., None], pc[..., 3:]], dim=-1)


def box3d_corners(centers: torch.Tensor, headings: torch.Tensor,
                  sizes: torch.Tensor) -> torch.Tensor:
    """Differentiable 8-corner computation, (N, 3)+(N,)+(N, 3 lwh) -> (N, 8, 3).

    Corner ordering matches the reference (`models/model_util.py:48-72`):
    bottom (y=+h/2) face first, x: + + - - + + - -, z: + - - + + - - +.
    """
    l, w, h = sizes[..., 0], sizes[..., 1], sizes[..., 2]
    kw = dict(dtype=sizes.dtype, device=sizes.device)
    sx = torch.tensor([1, 1, -1, -1, 1, 1, -1, -1], **kw)
    sy = torch.tensor([1, 1, 1, 1, -1, -1, -1, -1], **kw)
    sz = torch.tensor([1, -1, -1, 1, 1, -1, -1, 1], **kw)
    x = 0.5 * l[..., None] * sx  # (N, 8)
    y = 0.5 * h[..., None] * sy
    z = 0.5 * w[..., None] * sz
    c, s = torch.cos(headings), torch.sin(headings)
    # roty(heading) applied row-wise: x' = c*x + s*z ; z' = -s*x + c*z
    xr = c[..., None] * x + s[..., None] * z
    zr = -s[..., None] * x + c[..., None] * z
    corners = torch.stack([xr, y, zr], dim=-1)  # (N, 8, 3)
    return corners + centers[..., None, :]


def points_in_box3d(points: torch.Tensor, center: torch.Tensor,
                    size: torch.Tensor, heading: torch.Tensor,
                    eps: float = 0.0) -> torch.Tensor:
    """Inclusive inside-test of points (..., N, 3) against one box per batch.

    center (..., 3), size (..., 3 lwh), heading (...,) -> bool (..., N).
    """
    l, w, h = size[..., 0], size[..., 1], size[..., 2]
    d = points[..., :3] - center[..., None, :]
    c, s = torch.cos(heading)[..., None], torch.sin(heading)[..., None]
    # local = roty(heading)^T @ d
    lx = c * d[..., 0] - s * d[..., 2]
    ly = d[..., 1]
    lz = s * d[..., 0] + c * d[..., 2]
    return ((lx.abs() <= 0.5 * l[..., None] + eps)
            & (ly.abs() <= 0.5 * h[..., None] + eps)
            & (lz.abs() <= 0.5 * w[..., None] + eps))


def project_image_to_rect(uv_depth: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Back-project (..., N, 3) pixel+depth through per-batch P (..., 3, 4)."""
    c_u, c_v = P[..., 0, 2], P[..., 1, 2]
    f_u, f_v = P[..., 0, 0], P[..., 1, 1]
    b_x = P[..., 0, 3] / (-f_u)
    b_y = P[..., 1, 3] / (-f_v)
    z = uv_depth[..., 2]
    x = (uv_depth[..., 0] - c_u[..., None]) * z / f_u[..., None] + b_x[..., None]
    y = (uv_depth[..., 1] - c_v[..., None]) * z / f_v[..., None] + b_y[..., None]
    return torch.stack([x, y, z], dim=-1)
