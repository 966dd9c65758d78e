"""A cls head fitted to the label rule, in place of a trained stage-1 head.

Frozen from ``fit_cls_head`` in ``chip_smoke.py`` at commit ca7cd01. The
seeded head scores all of a frustum's sections foreground or none of them,
so the driver's compaction and host postprocess would see traffic no
trained model sends. The fit is ridge least squares on the seeded trunk's
section features (frozen), positives weighted up to balance the negatives,
with the threshold set so that the fitted frustums score as many sections
foreground as their labels hold. The smoke took the features from the
program's forward with an identity head; here they come from the
reference's forward (``reference.model.forward``'s head input), so the
weights owe nothing to the program.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def fit_cls_head(params: dict, feats: torch.Tensor, fg_labels: torch.Tensor) -> str:
    """Set ``params['cls_out.*']`` from head inputs ``feats`` (n, L, C) and
    the label rule's foreground ``fg_labels`` (n, L) bool; returns the line
    that reports the fit."""
    n, _, c = feats.shape
    device = feats.device
    x = feats.double().flatten(0, 1)  # (n * L, C)
    x = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    y = fg_labels.to(device).flatten()
    sw = torch.where(y, (~y).sum() / y.sum(), 1.0).double()[:, None]
    gram = (x * sw).T @ x + torch.eye(c + 1, dtype=x.dtype, device=device)
    w = torch.linalg.solve(gram, (x * sw).T @ (2.0 * y.double() - 1.0))
    margin = x @ w
    threshold = torch.sort(margin, descending=True).values[int(y.sum())]
    w[c] -= threshold
    fg = (margin > threshold).view(n, -1).cpu()
    # the fitted margin becomes logit_fg - logit_bg
    params["cls_out.weight"] = (torch.stack([-w[:c], w[:c]]) / 2).float()[:, :, None]
    params["cls_out.bias"] = (torch.stack([-w[c], w[c]]) / 2).float()
    labels = fg_labels.cpu()
    count = fg.sum(dim=1)
    return (f"cls head fitted on {n} frustums: {count.float().mean().item():.3f} "
            f"foreground sections a frustum (labels "
            f"{labels.sum(dim=1).float().mean().item():.3f}), median "
            f"{count.median().item()}, max {count.max().item()}, "
            f"{(count == 0).float().mean().item():.1%} with none (argmax fallback), "
            f"{(count > 64).sum().item()} over the 64 cap; recall "
            f"{(fg & labels).sum().item() / max(labels.sum().item(), 1):.3f}")
