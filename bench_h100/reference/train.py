"""The first training steps worked out again, and how far the program's lie.

The loss is the detector's (Wang and Jia's Frustum ConvNet): a focal loss
(alpha 0.25, gamma 2) over the sections labeled foreground (1) or
background (0), -1 ignored, normalized by the foreground count; over the
foreground sections, a Huber loss (delta 3) on the center offset's length,
cross entropy on the heading bin (12 bins, the angle shifted by half a bin)
and on the size template, Huber (delta 1) on the heading residual (in half
bins) and on the length of the size residual (relative to the template),
and Huber (delta 1) on the mean distance of the 8 corners of the decoded
box (the ground-truth bin and template with the predicted residuals) to
the ground truth's or its flip's, whichever is nearer. Total: focal + center
+ heading CE + size CE + 20 heading residual + 20 size residual + 10 corners.
Adam (0.9, 0.999, eps 1e-8) with the weight decay added to the gradient,
at the configuration's rate in float32.

``steps`` runs the steps from the initial weights on the given batches;
``compare`` turns the program's readings (losses and norms by leaf) and the
reference's steps into the numbers the cell holds to its limits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_h100.reference.model import forward, split_reg, strict_fp32
from bench_h100.reference.spec import ModelSpec

BETAS = (0.9, 0.999)
EPS = 1e-8
NOUGHT = 1e-3  # a leaf whose gradient is under this share of the median leaf's


def _huber(e, delta):
    a = e.abs()
    q = torch.minimum(a, a.new_tensor(delta))
    return 0.5 * q * q + delta * (a - q)


def _corners(center, heading, size):
    l, w, h = size[..., 0], size[..., 1], size[..., 2]
    sx = center.new_tensor([1, 1, -1, -1, 1, 1, -1, -1])
    sy = center.new_tensor([1, 1, 1, 1, -1, -1, -1, -1])
    sz = center.new_tensor([1, -1, -1, 1, 1, -1, -1, 1])
    x, y, z = 0.5 * l[..., None] * sx, 0.5 * h[..., None] * sy, 0.5 * w[..., None] * sz
    c, s = torch.cos(heading)[..., None], torch.sin(heading)[..., None]
    return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1) + center[..., None, :]


def loss(params, spec: ModelSpec, batch: dict) -> torch.Tensor:
    refs = list(batch["refs"])
    cls, reg, _ = forward(params, spec, batch["point_cloud"], batch["one_hot"], refs,
                          train=True)
    b, n = cls.shape[:2]
    rows = b * n
    label = batch["cls_label"].reshape(rows)
    fg = (label == 1).to(cls.dtype)
    num_fg = torch.clamp(fg.sum(), min=1.0)
    probs = torch.softmax(cls.reshape(rows, -1), dim=-1)
    safe = label.clamp(0, 1)
    p_t = torch.gather(probs, 1, safe[:, None])[:, 0]
    alpha = torch.where(safe >= 1, 0.25, 0.75).to(cls.dtype)
    focal = -alpha * (1 - p_t) ** 2 * torch.log(p_t + 1e-14)
    cls_loss = torch.where(label != -1, focal, torch.zeros_like(focal)).sum() / num_fg

    def per_row(t):
        return t[:, None].expand(b, n, *t.shape[1:]).reshape(rows, *t.shape[1:])

    center = per_row(batch["box3d_center"])
    heading = per_row(batch["box3d_heading"])
    size = per_row(batch["box3d_size"])
    template = per_row(batch["size_class"])
    off, h_scores, h_res, s_scores, s_res = split_reg(reg.reshape(rows, -1), spec)
    ref2 = refs[1].reshape(rows, 3)
    mean_sizes = torch.tensor(spec.mean_sizes, dtype=cls.dtype, device=cls.device)

    def fg_mean(v):
        return (v * fg).sum() / num_fg

    center_loss = fg_mean(_huber(torch.linalg.vector_norm(center - ref2 - off, dim=-1), 3.0))
    per = 2 * math.pi / spec.num_bins
    shifted = torch.remainder(torch.remainder(heading, 2 * math.pi) + per / 2, 2 * math.pi)
    hbin = torch.floor(shifted / per).long()
    hres_label = (shifted - (hbin.to(cls.dtype) * per + per / 2)) / (per / 2)
    h_cls = fg_mean(-torch.gather(torch.log_softmax(h_scores, -1), 1, hbin[:, None])[:, 0])
    h_res_sel = torch.gather(h_res, 1, hbin[:, None])[:, 0]
    h_res_loss = fg_mean(_huber(h_res_sel - hres_label, 1.0))
    s_cls = fg_mean(-torch.gather(torch.log_softmax(s_scores, -1), 1, template[:, None])[:, 0])
    ex = mean_sizes[template]
    s_res_sel = torch.gather(s_res, 1, template[:, None, None].expand(rows, 1, 3))[:, 0]
    s_res_loss = fg_mean(_huber(torch.linalg.vector_norm((size - ex) / ex - s_res_sel, dim=-1), 1.0))
    angle = hbin.to(cls.dtype) * per + h_res_sel * (per / 2)
    angle = torch.where(angle > math.pi, angle - 2 * math.pi, angle)
    pred = _corners(ref2 + off, angle, s_res_sel * ex + ex)
    gt = _corners(center, heading, size)
    flip = _corners(center, heading + math.pi, size)
    dist = torch.minimum(torch.linalg.vector_norm(pred - gt, dim=-1).mean(-1),
                         torch.linalg.vector_norm(pred - flip, dim=-1).mean(-1))
    corner_loss = fg_mean(_huber(dist, 1.0))
    return cls_loss + (center_loss + h_cls + s_cls + 20 * h_res_loss + 20 * s_res_loss
                       + 10 * corner_loss)


def steps(init: dict, names, spec: ModelSpec, batches: list, lr: float, weight_decay: float,
          device, allow_tf32: bool = False) -> dict:
    """``len(batches)`` steps from ``init`` (the leaves ``names``):
    {"losses": [...], "first_grad": {name: gradient + decay of step 1},
    "loss_grad": {name: the loss's gradient of step 1}, "change": {name:
    parameter after the last step - initial}}."""
    strict_fp32(allow_tf32)
    try:
        params = {k: v.detach().clone() for k, v in init.items()}
        m = {k: torch.zeros_like(params[k]) for k in names}
        v = {k: torch.zeros_like(params[k]) for k in names}
        lr = float(np.float32(lr))
        out = {"losses": []}
        for t, batch in enumerate(batches, start=1):
            leaves = {k: params[k].requires_grad_(True) for k in names}
            total = loss(params, spec, _tensors(batch, device))
            grads = torch.autograd.grad(total, [leaves[k] for k in names])
            out["losses"].append(float(total.detach()))
            with torch.no_grad():
                if t == 1:
                    out["loss_grad"] = {k: g.clone() for k, g in zip(names, grads)}
                    out["first_grad"] = {k: g + weight_decay * params[k]
                                         for k, g in zip(names, grads)}
                for k, g in zip(names, grads):
                    p = params[k].detach()
                    g = g + weight_decay * p
                    m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    v[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    m_hat = m[k] / (1 - BETAS[0] ** t)
                    v_hat = v[k] / (1 - BETAS[1] ** t)
                    params[k] = p - lr * m_hat / (torch.sqrt(v_hat) + EPS)
        out["change"] = {k: (params[k] - init[k]).detach() for k in names}
        return out
    finally:
        strict_fp32(False)


def _tensors(batch: dict, device) -> dict:
    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.to(device, torch.float32 if t.is_floating_point() else None)

    return {"point_cloud": put(batch["point_cloud"]), "one_hot": put(batch["one_hot"]),
            "refs": tuple(put(r) for r in batch["refs"]),
            **{k: put(batch[k]) for k in ("cls_label", "box3d_center", "box3d_heading",
                                          "box3d_size", "size_class")}}


def leaf_norms(leaves: dict) -> dict:
    """The norm of each leaf, in float64."""
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def readings(out: dict) -> dict:
    """What the check reads of steps run on the program's side, as the
    program's are read: the losses and, by leaf, the norms of the first
    gradient and of the change."""
    return {"losses": list(out["losses"]), "first_grad": leaf_norms(out["first_grad"]),
            "change": leaf_norms(out["change"])}


def _leaf_gaps(got: dict, want: dict, keep=None) -> list:
    """Per leaf, the gap between its norm on the two sides (``got``: the
    norms; ``want``: the reference's leaves), over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    norms = leaf_norms(want)
    median = float(np.median(list(norms.values())))
    return [abs(got[k] - norms[k]) / max(norms[k], median, 1e-30)
            for k in want if keep is None or k in keep]


def compare(program: dict, ref: dict) -> dict:
    """``loss_gap``: the widest relative gap of a step's loss
    (``loss_gap_first``: the first step's); ``grad_gap``: the widest gap of
    the first gradient's norm by leaf; ``change_gap``: the widest gap of the
    norm of the parameters' change after the steps by leaf
    (``change_gap_median``: the median leaf's gap), over the leaves whose
    loss gradient in the reference is not nought (at least ``NOUGHT`` of the
    median leaf's). ``program`` holds the readings (``readings``) of one
    stretch of steps."""
    losses = [abs(p - r) / abs(r) for p, r in zip(program["losses"], ref["losses"])]
    norms = leaf_norms(ref["loss_grad"])
    median = float(np.median(list(norms.values())))
    moving = {k for k, n in norms.items() if n >= NOUGHT * median}
    change = _leaf_gaps(program["change"], ref["change"], moving)
    return {"loss_gap": max(losses), "loss_gap_first": losses[0],
            "grad_gap": max(_leaf_gaps(program["first_grad"], ref["first_grad"])),
            "change_gap": max(change), "change_gap_median": float(np.median(change))}
