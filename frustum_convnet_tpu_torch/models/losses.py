"""Loss primitives in PyTorch: huber, masked softmax focal loss, masked CE.

Counterpart of ``frustum_convnet_tpu/models/losses.py``, with the same dense
masking in place of the reference's fg-row gather (same values and
gradients, static shapes).

Data parallelism: ``psum`` (``parallel.mesh.global_sum`` under a process
group, None alone) sums a count over the ranks before it is clamped at 1,
so every normaliser is the global batch's, as it is in JAX under the mesh,
and each rank's loss is its share of the global loss.
"""

from __future__ import annotations

import torch


def huber(error: torch.Tensor, delta: float) -> torch.Tensor:
    """Elementwise huber; the caller reduces."""
    abs_e = error.abs()
    # minimum, not clamp: at |e| == delta both split the gradient as jnp does
    quad = torch.minimum(abs_e, abs_e.new_tensor(delta))
    return 0.5 * quad ** 2 + delta * (abs_e - quad)


def identity(t: torch.Tensor) -> torch.Tensor:
    """The sum over one rank: ``t`` itself (the default ``psum``)."""
    return t


def masked_mean(values: torch.Tensor, mask: torch.Tensor, denom=None,
                psum=None) -> torch.Tensor:
    """sum(values * mask) / denom; denom defaults to clamp(psum(sum(mask)), 1)."""
    mask = mask.to(values.dtype)
    if denom is None:
        denom = torch.clamp((psum or identity)(mask.sum()), min=1.0)
    return torch.sum(values * mask) / denom


def softmax_focal_loss_masked(probs: torch.Tensor, labels: torch.Tensor,
                              alpha: float = 0.25, gamma: float = 2.0,
                              ignore_value: int = -1, psum=None) -> torch.Tensor:
    """Focal loss over {0, 1} labels with -1 = ignore, normalized by the
    number of positive labels (over the ranks with ``psum``) clamped at 1
    (a batch without foreground keeps its background terms instead of
    dividing by ~0).

    probs (R, C) softmax probabilities; labels (R,) in {-1, 0, 1}.
    """
    keep = labels != ignore_value
    num_fg = torch.clamp((psum or identity)((labels > 0).sum().to(probs.dtype)), min=1.0)
    safe_labels = labels.clamp(0, probs.shape[-1] - 1).long()
    p_t = torch.gather(probs, -1, safe_labels[:, None])[:, 0]
    alpha_t = torch.where(safe_labels >= 1, alpha, 1.0 - alpha).to(probs.dtype)
    loss = -alpha_t * (1.0 - p_t) ** gamma * torch.log(p_t + 1e-14)
    return torch.sum(torch.where(keep, loss, torch.zeros_like(loss))) / num_fg


def cross_entropy_masked(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor, denom=None) -> torch.Tensor:
    """Mean CE over masked rows (== F.cross_entropy on the gathered rows).

    logits (R, C), labels (R,) int, mask (R,) bool.
    """
    logp = torch.log_softmax(logits, dim=-1)
    safe_labels = labels.clamp(0, logits.shape[-1] - 1).long()
    nll = -torch.gather(logp, -1, safe_labels[:, None])[:, 0]
    return masked_mean(nll, mask, denom)
