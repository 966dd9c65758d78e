"""What the served SUN-RGBD detections should be, and how far the program's lie from it.

SUN-RGBD serving keeps, for each frustum, the section its cls head scores
most foreground (``top``), or every section with a foreground probability
over 0.5, the argmax where none is (``nms``); it decodes each to a
centroid-anchored box (tx, ty, tz, l, w, h, ry: no h/2 shift) with score =
the 2D detector's probability + the largest size-template probability, and
drops boxes with a side under 0.01 m. The reference works that out again
from the inputs (points as the float16 upload leaves them, the 5 ladders,
the one-hot, the rotation and the detector's probability) and the weights
with ``reference.model``'s forward, section by section:

* ``section_table`` is ``reference.serve.section_table`` with SUN's values:
  per section, the foreground margin and the box of the best heading bin
  and size template and of the runner-up of each, a runner-up within
  ``TIE`` logits of the best counting as an answer too.
* ``compare`` and ``rule_detections`` are ``reference.serve``'s, whose rule
  is 'nms': a foreground probability over 0.5 is a margin over 0. 'top'
  takes the argmax of the float32 foreground probability, the first
  section where several tie, and near 1 that probability is coarse (above
  a margin of 24 ln 2 it is 1.0 exactly, so sections far apart in margin
  tie). ``rule_table`` states 'top' to that rule: each section's margin is
  replaced by the margin its float32 probability stands for (``key``:
  logit(p) in float64, 25 ln 2 where p is 1), and each frustum's keys are
  moved below 0 by one amount, so the rule takes every frustum's argmax,
  tied sections reading a lead of 0; ``decision_gap`` is then the
  reference's lead, in those logits, of its best section over the one
  served.
* 'top' serves at most one detection a frustum, and none only where the
  section it took was dropped for its size. So ``compare`` also reads
  each frustum: two detections read ``MISMATCH``; none reads how far the
  reference lies from that, the least over its sections of the larger of
  the section's lead to the best (in logits) and its best box's smallest
  side over 0.01 m (in metres, as ``reference.serve`` reads a box kept or
  dropped). A frustum left out whole thus reads its box's size however
  its sections tie.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_h100.reference import serve as ref_serve
from bench_h100.reference.model import (forward, heading_of, size_of, split_reg,
                                        strict_fp32)
from bench_h100.reference.spec import ModelSpec

TIE = ref_serve.TIE
SATURATED = 25 * math.log(2)  # the key of a float32 probability of 1.0


@torch.no_grad()
def section_table(params, spec: ModelSpec, inputs: dict, device, block: int = 128,
                  allow_tf32: bool = False) -> dict:
    """Per section of every frustum: ``margin`` (F, L), ``key`` (F, L) the
    margin its float32 foreground probability stands for, ``values`` (F, L,
    4, 8) float64 of the candidates (best bin and template first), ``ok``
    (F, L, 4) which candidates are answers, ``min_size`` (F, L) of the best.
    ``inputs`` holds numpy arrays: points (F, N, 3) float32, one_hot, refs
    (a list of the 5 ladders (F, M_i, 3)), rot_angle, rgb_prob."""
    strict_fp32(allow_tf32)
    try:
        mean_sizes = torch.tensor(spec.mean_sizes, dtype=torch.float32, device=device)
        parts = {k: [] for k in ("margin", "key", "values", "ok", "min_size")}
        count = len(inputs["points"])
        for lo in range(0, count, block):
            sl = slice(lo, min(lo + block, count))

            def put(x):
                return torch.from_numpy(np.ascontiguousarray(x[sl])).to(device)

            refs = [put(r) for r in inputs["refs"]]
            cls, reg, _ = forward(params, spec, put(inputs["points"]),
                                  put(inputs["one_hot"]), refs)
            center_off, h_scores, h_res, s_scores, s_res = split_reg(reg, spec)
            centers = refs[1] + center_off
            h_top = torch.topk(h_scores, 2, dim=-1)
            s_top = torch.topk(s_scores, 2, dim=-1)
            rot = put(inputs["rot_angle"]).double()[:, None]
            score = put(inputs["rgb_prob"])[:, None] + torch.softmax(s_scores, dim=-1).amax(-1)
            values, ok = [], []
            for a in (0, 1):
                heading = heading_of(h_res, h_top.indices[..., a], spec.num_bins)
                for c in (0, 1):
                    size = size_of(s_res, s_top.indices[..., c], mean_sizes)
                    values.append(sun_values(centers, heading, size, rot, score))
                    ok.append((h_top.values[..., 0] - h_top.values[..., a] <= TIE)
                              & (s_top.values[..., 0] - s_top.values[..., c] <= TIE))
            best = size_of(s_res, s_top.indices[..., 0], mean_sizes)
            parts["margin"].append((cls[..., 1] - cls[..., 0]).double())
            p = torch.softmax(cls, dim=-1)[..., 1].double()
            key = torch.where(p < 1, torch.log(p) - torch.log1p(-p),
                              torch.full_like(p, SATURATED))
            parts["key"].append(key.clamp(min=-SATURATED * 6))  # p = 0 under every p > 0
            parts["values"].append(torch.stack(values, dim=2))
            parts["ok"].append(torch.stack(ok, dim=2))
            parts["min_size"].append(best.amin(dim=-1).double())
        return {k: torch.cat(v) for k, v in parts.items()}
    finally:
        strict_fp32(False)


def sun_values(centers, heading, size, rot, score):
    """(.., 8) float64: the SUN-RGBD label values of boxes in the center
    view (centers (.., 3), heading, size (.., 3) as l, w, h) rotated back by
    ``rot``, centroid-anchored, and the score."""
    c = centers.double()
    cos, sin = torch.cos(-rot), torch.sin(-rot)
    size = size.double()
    return torch.stack([cos * c[..., 0] - sin * c[..., 2], c[..., 1],
                        sin * c[..., 0] + cos * c[..., 2], size[..., 0], size[..., 1],
                        size[..., 2], heading.double() + rot, score.double()], dim=-1)


def rule_table(table: dict, method: str) -> dict:
    """``table`` as ``reference.serve``'s rule reads it for ``method``: as it
    is for 'nms'; for 'top' with each frustum's keys, less their largest
    and 1, as its margins, so that no section is foreground and the rule
    takes the argmax of the float32 probability."""
    if method == "nms":
        return table
    k = table["key"]
    return dict(table, margin=k - k.amax(dim=1, keepdim=True) - 1.0)


def compare(served: tuple, table: dict, method: str) -> dict:
    """``box_gap`` and ``decision_gap`` of one call's detections
    (``reference.serve.served_arrays``'s), with the counts served and
    expected; for 'top' with each frustum's count read too (above)."""
    gaps = ref_serve.compare(served, rule_table(table, method))
    if method == "nms":
        return gaps
    key = table["key"]
    per_frustum = np.bincount(served[1], minlength=key.shape[0])
    if (per_frustum > 1).any():
        return dict(gaps, decision_gap=ref_serve.MISMATCH)
    lead = key.amax(dim=1, keepdim=True) - key
    size_room = table["min_size"] - ref_serve.MIN_SIZE
    to_leave = torch.maximum(lead, size_room).clamp(min=0).amin(dim=1)  # (F,)
    empty = torch.from_numpy(per_frustum == 0).to(key.device)
    missed = float(torch.where(empty, to_leave, torch.zeros_like(to_leave)).max())
    return dict(gaps, decision_gap=max(gaps["decision_gap"], missed))


def rule_detections(table: dict, frame_ids, box2d, method: str) -> dict:
    """The detections the serving rule makes from ``table``: the control's."""
    return ref_serve.rule_detections(rule_table(table, method), frame_ids, box2d)
