"""Detection losses, training metrics and box decoding of the network outputs.

Counterpart of ``frustum_convnet_tpu/models/det.py``: ``decode_outputs``
(:32-60), ``compute_losses`` (:63-165), ``_compute_metrics`` (:177-202),
``LOSS_KEYS`` and ``metric_keys``. Every per-row loss is computed densely and
reduced with foreground masks, as in the JAX package. The metrics carry no
gradient: they are computed from detached tensors.

Under data parallelism ``compute_losses`` takes ``psum``, the sum over the
ranks (``parallel.mesh.global_sum``): every normaliser is then
``clamp(psum(local count), 1)``, the global batch's, and each loss and
metric a rank returns is its share; their sum over the ranks is the value
JAX computes on the global batch (``parallel.train_step`` reduces them).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from frustum_convnet_tpu_torch.models.spec import DetModelSpec
from frustum_convnet_tpu_torch.core import codecs
from frustum_convnet_tpu_torch.core.geometry import box3d_corners
from frustum_convnet_tpu_torch.core.iou import iou_pair_3d
from frustum_convnet_tpu_torch.models import losses as L
from frustum_convnet_tpu_torch.models.net import slice_reg_output

LOSS_KEYS = ("total_loss", "cls_loss", "center_loss", "head_cls_loss",
             "head_res_loss", "size_cls_loss", "size_res_loss", "corners_loss")


def metric_keys(iou_thresh: float):
    return ("cls_acc", "head_acc", "size_acc", "IoU_2D", "IoU_3D",
            f"IoU_{iou_thresh}")


_SIZE_TABLES: Dict[tuple, torch.Tensor] = {}  # (device, dtype, mean sizes) -> table


def _mean_sizes(spec: DetModelSpec, reg: torch.Tensor) -> torch.Tensor:
    """The size table in the computation dtype, never below float32, so an
    f64 parity run sees f64 constants.

    Made once per device, dtype and ``spec.mean_sizes`` and kept: a copy to
    the card on every decode would wait there for the whole forward queued
    before it. Made outside inference mode, so that a table a serving call
    made first still serves a training loss's backward."""
    dtype = torch.promote_types(reg.dtype, torch.float32)
    key = (reg.device, dtype, spec.mean_sizes)
    table = _SIZE_TABLES.get(key)
    if table is None:
        with torch.inference_mode(False):
            table = _SIZE_TABLES[key] = torch.as_tensor(
                np.asarray(spec.mean_sizes, np.float64), dtype=dtype, device=reg.device)
    return table


def decode_outputs(spec: DetModelSpec, cls_logits, reg, ref2):
    """Args: cls_logits (B, L, 2), reg (B, L, R), ref2 (B, L, 3).

    Returns dict with cls_probs (B, L, 2), centers (B, L, 3), headings (B, L),
    sizes (B, L, 3), heading_probs (B, L, nb), size_probs (B, L, ns).
    """
    mean_sizes = _mean_sizes(spec, reg)
    center_off, h_scores, h_res, s_scores, s_res = slice_reg_output(reg, spec)
    cls_probs = torch.softmax(cls_logits, dim=-1)
    heading_probs = torch.softmax(h_scores, dim=-1)
    size_probs = torch.softmax(s_scores, dim=-1)
    heading_bin = torch.argmax(heading_probs, dim=-1)
    size_cls = torch.argmax(size_probs, dim=-1)
    return {
        "cls_probs": cls_probs,
        "centers": ref2 + center_off,
        "headings": codecs.angle_decode(h_res, heading_bin,
                                        num_bins=spec.num_bins),
        "sizes": codecs.size_decode(s_res, mean_sizes, size_cls),
        "heading_probs": heading_probs,
        "size_probs": size_probs,
    }


def compute_losses(
    spec: DetModelSpec,
    cls_logits: torch.Tensor,  # (B, L, 2)
    reg: torch.Tensor,  # (B, L, R)
    ref2: torch.Tensor,  # (B, L, 3)
    labels: Dict[str, torch.Tensor],
    loss_weights: Dict[str, float],
    iou_thresh: float = 0.7,
    compute_metrics: bool = True,
    psum=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Training losses + monitoring metrics.

    labels: cls_label (B, L) in {-1, 0, 1}; box3d_center (B, 3);
    box3d_heading (B,); box3d_size (B, 3); size_class (B,). ``psum`` (None:
    this batch alone) sums the normalisers' counts over the ranks before
    the clamp.
    """
    mean_sizes = _mean_sizes(spec, reg)
    b, num_out = cls_logits.shape[0], cls_logits.shape[1]
    r = b * num_out

    cls_label = labels["cls_label"].reshape(r)
    fg = cls_label == 1
    num_fg = torch.clamp((psum or L.identity)(fg.sum().to(reg.dtype)), min=1.0)

    # classification: focal with ignore (-1), normalized by #fg
    cls_probs = torch.softmax(cls_logits.reshape(r, -1), dim=-1)
    cls_loss = L.softmax_focal_loss_masked(cls_probs, cls_label, psum=psum)

    # per-frustum box labels broadcast to every section row
    center_label = labels["box3d_center"][:, None, :].expand(b, num_out, 3).reshape(r, 3)
    heading_label = labels["box3d_heading"][:, None].expand(b, num_out).reshape(r)
    size_label = labels["box3d_size"][:, None, :].expand(b, num_out, 3).reshape(r, 3)
    size_cls_label = labels["size_class"][:, None].expand(b, num_out).reshape(r)

    center_off, h_scores, h_res, s_scores, s_res = slice_reg_output(
        reg.reshape(r, -1), spec)
    ref2_flat = ref2.reshape(r, 3)

    center_gt_off = codecs.center_encode(center_label, ref2_flat)
    heading_bin_label, heading_res_label = codecs.angle_encode(heading_label,
                                                               spec.num_bins)
    size_res_label = codecs.size_encode(size_label, mean_sizes, size_cls_label)

    # center: huber(||offset error||, delta=3) over fg
    center_dist = torch.linalg.vector_norm(center_gt_off - center_off, dim=-1)
    center_loss = L.masked_mean(L.huber(center_dist, 3.0), fg, num_fg)

    # heading: CE + huber on the gt-bin residual
    heading_cls_loss = L.cross_entropy_masked(h_scores, heading_bin_label, fg, num_fg)
    h_res_sel = torch.gather(h_res, 1, heading_bin_label[:, None].long())[:, 0]
    heading_res_loss = L.masked_mean(L.huber(h_res_sel - heading_res_label, 1.0),
                                     fg, num_fg)

    # size: CE + huber on ||residual error||
    size_cls_loss = L.cross_entropy_masked(s_scores, size_cls_label, fg, num_fg)
    s_res_sel = torch.gather(
        s_res, 1, size_cls_label.long()[:, None, None].expand(r, 1, 3))[:, 0, :]
    size_norm_dist = torch.linalg.vector_norm(size_res_label - s_res_sel, dim=-1)
    size_res_loss = L.masked_mean(L.huber(size_norm_dist, 1.0), fg, num_fg)

    # corner loss with the flipped-gt minimum; torch.minimum splits the
    # gradient 50/50 at a tie as jnp.minimum does
    center_preds = codecs.center_decode(ref2_flat, center_off)
    heading_dec = codecs.angle_decode(h_res, heading_bin_label, num_bins=spec.num_bins)
    size_dec = codecs.size_decode(s_res, mean_sizes, size_cls_label)
    corners_gt = box3d_corners(center_label, heading_label, size_label)
    corners_gt_flip = box3d_corners(center_label, heading_label + math.pi, size_label)
    corners_pred = box3d_corners(center_preds, heading_dec, size_dec)
    dist = torch.minimum(
        torch.linalg.vector_norm(corners_pred - corners_gt, dim=-1).mean(-1),
        torch.linalg.vector_norm(corners_pred - corners_gt_flip, dim=-1).mean(-1),
    )
    corners_loss = L.masked_mean(L.huber(dist, 1.0), fg, num_fg)

    w_box = loss_weights.get("box", 1.0)
    w_corner = loss_weights.get("corner", 10.0)
    w_hres = loss_weights.get("head_res", 20.0)
    w_sres = loss_weights.get("size_res", 20.0)
    total = cls_loss + w_box * (
        center_loss + heading_cls_loss + size_cls_loss
        + w_hres * heading_res_loss + w_sres * size_res_loss
        + w_corner * corners_loss
    )

    loss_dict = {
        "total_loss": total,
        "cls_loss": cls_loss,
        "center_loss": center_loss,
        "head_cls_loss": heading_cls_loss,
        "head_res_loss": heading_res_loss,
        "size_cls_loss": size_cls_loss,
        "size_res_loss": size_res_loss,
        "corners_loss": corners_loss,
    }

    metrics = {}
    if compute_metrics:
        with torch.no_grad():
            metrics = _compute_metrics(
                spec, cls_probs.detach(), cls_label, fg, num_fg.detach(),
                h_scores.detach(), h_res.detach(), heading_bin_label,
                s_scores.detach(), s_res.detach(), size_cls_label,
                center_preds.detach(), corners_gt.detach(), mean_sizes,
                iou_thresh, psum)
    return loss_dict, metrics


def _compute_metrics(spec, cls_probs, cls_label, fg, num_fg,
                     h_scores, h_res, heading_bin_label,
                     s_scores, s_res, size_cls_label,
                     center_preds, corners_gt, mean_sizes, iou_thresh, psum=None):
    """Monitoring metrics (ref `det_base.py:478-503`), on the device; the
    classification accuracy's count of labeled sections is summed by
    ``psum`` like ``num_fg``."""
    f32 = torch.float32
    keep = cls_label != -1
    cls_pred = torch.argmax(cls_probs, dim=-1)
    cls_acc = L.masked_mean((cls_pred == cls_label.clamp(min=0)).to(f32), keep,
                            psum=psum)
    head_acc = L.masked_mean(
        (torch.argmax(h_scores, -1) == heading_bin_label).to(f32), fg, num_fg)
    size_acc = L.masked_mean(
        (torch.argmax(s_scores, -1) == size_cls_label).to(f32), fg, num_fg)

    # predicted boxes with the argmax bins, as the reference metric does
    heading_pred = codecs.angle_decode(h_res, torch.argmax(h_scores, -1),
                                       num_bins=spec.num_bins)
    size_pred = codecs.size_decode(s_res, mean_sizes, torch.argmax(s_scores, -1))
    corners_pred = box3d_corners(center_preds, heading_pred, size_pred)
    iou_bev, iou_3d = iou_pair_3d(corners_pred, corners_gt)
    return {
        "cls_acc": cls_acc,
        "head_acc": head_acc,
        "size_acc": size_acc,
        "IoU_2D": L.masked_mean(iou_bev, fg, num_fg),
        "IoU_3D": L.masked_mean(iou_3d, fg, num_fg),
        f"IoU_{iou_thresh}": L.masked_mean((iou_3d >= iou_thresh).to(f32),
                                           fg, num_fg),
    }
