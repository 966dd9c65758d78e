"""What the served detections should be, and how far the program's lie from it.

Serving keeps, for each frustum, the output sections its cls head scores
foreground (the argmax section when none is), decodes each to a KITTI box
(h, w, l, tx, ty, tz, ry) with score = foreground probability + the 2D
detector's probability, and drops boxes with a side under 0.01 m. The
reference works that out again from the inputs (points as the float16
upload leaves them, the ladder basis, the one-hot, the rotation and the
detector's probability) and the weights, section by section:

* ``section_table`` runs the reference forward in blocks and keeps, per
  section, the foreground margin (logit_fg - logit_bg) and the decoded box
  of the best heading bin and size template and of the runner-up of each.
  A runner-up within ``TIE`` logits of the best counts as an answer too: a
  near tie flips on rounding.
* ``compare`` matches each served detection to the section whose box lies
  nearest, and returns two numbers. ``box_gap``: the widest relative gap,
  over all served detections and their eight values, to the matched
  section (the angle modulo 2 pi). ``decision_gap``: the widest distance,
  in logits, by which the reference lies from a decision the program took:
  a section served that the rule would not serve, or one the rule serves
  that was not (for a frustum with no foreground section, the lead of its
  argmax). A served detection that matches no frustum, or two that match
  one section, reads ``MISMATCH``.
* ``rule_detections`` applies the rule to a table, as the program would:
  the control's detections.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_h100.reference.model import (forward, heading_of, ladders, size_of,
                                        split_reg, strict_fp32)
from bench_h100.reference.spec import ModelSpec

TIE = 1e-4  # logits within which two heading bins or size templates tie
MIN_SIZE = 0.01  # boxes with a smaller side are dropped
MISMATCH = 1e9  # the decision gap of an answer no frustum explains


@torch.no_grad()
def section_table(params, spec: ModelSpec, inputs: dict, device, block: int = 128,
                  allow_tf32: bool = False) -> dict:
    """Per section of every frustum: ``margin`` (F, L), ``values`` (F, L, 4,
    8) float64 of the candidates (best bin and template first), ``ok`` (F,
    L, 4) which candidates are answers, ``min_size`` (F, L) of the best.
    ``inputs`` holds numpy arrays: points (F, N, 3) float32, one_hot,
    ref_dir, ref_off, rot_angle, rgb_prob."""
    strict_fp32(allow_tf32)
    try:
        mean_sizes = torch.tensor(spec.mean_sizes, dtype=torch.float32, device=device)
        parts = {k: [] for k in ("margin", "values", "ok", "min_size")}
        count = len(inputs["points"])
        for lo in range(0, count, block):
            sl = slice(lo, min(lo + block, count))

            def put(key):
                return torch.from_numpy(np.ascontiguousarray(inputs[key][sl])).to(device)

            refs = ladders(put("ref_dir"), put("ref_off"), spec)
            cls, reg, _ = forward(params, spec, put("points"), put("one_hot"), refs)
            margin = cls[..., 1] - cls[..., 0]
            fg_prob = torch.softmax(cls, dim=-1)[..., 1]
            center_off, h_scores, h_res, s_scores, s_res = split_reg(reg, spec)
            centers = refs[1] + center_off
            h_top = torch.topk(h_scores, 2, dim=-1)
            s_top = torch.topk(s_scores, 2, dim=-1)
            rot = put("rot_angle").double()[:, None]
            score = fg_prob + put("rgb_prob")[:, None]
            values, ok = [], []
            for a in (0, 1):
                heading = heading_of(h_res, h_top.indices[..., a], spec.num_bins)
                for c in (0, 1):
                    size = size_of(s_res, s_top.indices[..., c], mean_sizes)
                    values.append(kitti_values(centers, heading, size, rot, score))
                    ok.append((h_top.values[..., 0] - h_top.values[..., a] <= TIE)
                              & (s_top.values[..., 0] - s_top.values[..., c] <= TIE))
            best = size_of(s_res, s_top.indices[..., 0], mean_sizes)
            parts["margin"].append(margin.double())
            parts["values"].append(torch.stack(values, dim=2))
            parts["ok"].append(torch.stack(ok, dim=2))
            parts["min_size"].append(best.amin(dim=-1).double())
        return {k: torch.cat(v) for k, v in parts.items()}
    finally:
        strict_fp32(False)


def kitti_values(centers, heading, size, rot, score):
    """(.., 8) float64: the KITTI label values of boxes in the center view
    (centers (.., 3), heading, size (.., 3) as l, w, h) rotated back by
    ``rot``, the box bottom at ty, and the score."""
    c = centers.double()
    cos, sin = torch.cos(-rot), torch.sin(-rot)
    tx = cos * c[..., 0] - sin * c[..., 2]
    tz = sin * c[..., 0] + cos * c[..., 2]
    size = size.double()
    h = size[..., 2]
    return torch.stack([tx, c[..., 1] + h / 2.0, tz, h, size[..., 1], size[..., 0],
                        heading.double() + rot, score.double()], dim=-1)


def _selection(table):
    """The rule's sections (F, L) and, per section, how far the reference
    lies from taking the other decision."""
    m = table["margin"]
    any_fg = (m > 0).any(dim=1, keepdim=True)
    top2 = torch.topk(m, 2, dim=1)
    top = torch.zeros_like(m, dtype=torch.bool).scatter_(1, top2.indices[:, :1], True)
    chosen = torch.where(any_fg, m > 0, top)
    lead = (top2.values[:, :1] - top2.values[:, 1:2]).expand_as(m)
    to_take = torch.where(any_fg, -m, top2.values[:, :1] - m)  # for sections not chosen
    to_drop = torch.where(any_fg, m, lead)  # for sections chosen
    kept = chosen & (table["min_size"] >= MIN_SIZE)
    return chosen, kept, to_take, to_drop


def served_arrays(det_results: dict, frustum_of: dict):
    """(values (D, 8) float64, frustum index (D,), unknown count) of a
    det_results dict {frame id: {type: [[x1, y1, x2, y2, tx, ty, tz, h, w,
    l, ry, score], ...]}}. A detection's frustum is the one of its frame
    with its 2D box."""
    rows, where, unknown = [], [], 0
    for frame, by_type in det_results.items():
        for dets in by_type.values():
            for d in dets:
                f = frustum_of.get((int(frame), tuple(float(v) for v in d[:4])))
                if f is None:
                    unknown += 1
                    continue
                rows.append([float(v) for v in d[4:12]])
                where.append(f)
    return (np.asarray(rows, np.float64).reshape(-1, 8),
            np.asarray(where, np.int64), unknown)


def compare(served: tuple, table: dict, chunk: int = 2048) -> dict:
    """``box_gap`` and ``decision_gap`` of one call's detections, as
    ``served_arrays`` gives them (see the module's docstring), with the
    counts served and expected."""
    device = table["margin"].device
    values, where, unknown = served
    frustums, sections = table["margin"].shape
    hits = torch.zeros(frustums, sections, dtype=torch.int32, device=device)
    box_gap = 0.0
    for lo in range(0, len(values), chunk):
        v = torch.from_numpy(values[lo:lo + chunk]).to(device)  # (D, 8)
        f = torch.from_numpy(where[lo:lo + chunk]).to(device)
        cand, ok = table["values"][f], table["ok"][f]  # (D, L, 4, 8), (D, L, 4)
        diff = (v[:, None, None, :] - cand).abs()
        ang = torch.remainder(diff[..., 6] + math.pi, 2 * math.pi) - math.pi
        diff[..., 6] = ang.abs()
        rel = (diff / torch.clamp(cand.abs(), min=1.0)).amax(dim=-1)
        rel = torch.where(ok, rel, torch.full_like(rel, math.inf)).amin(dim=-1)  # (D, L)
        gap, section = rel.min(dim=-1)
        box_gap = max(box_gap, float(gap.max()))
        hits.index_put_((f, section), torch.ones_like(f, dtype=torch.int32),
                        accumulate=True)
    chosen, kept, to_take, to_drop = _selection(table)
    size_room = table["min_size"] - MIN_SIZE
    wrong = torch.where((hits > 0) & ~chosen, to_take, torch.zeros_like(to_take))
    missed = torch.where((hits == 0) & kept, torch.minimum(to_drop, size_room),
                         torch.zeros_like(to_drop))
    decision_gap = max(float(wrong.max()), float(missed.max()), 0.0)
    if unknown or int((hits > 1).sum()):
        decision_gap = MISMATCH
    return {"box_gap": box_gap, "decision_gap": decision_gap,
            "served": len(values) + unknown, "expected": int(kept.sum())}


def rule_detections(table: dict, frame_ids, box2d) -> dict:
    """The detections the serving rule makes from ``table`` (the best bin
    and template), in the program's det_results layout."""
    chosen, kept, _, _ = _selection(table)
    f_idx, s_idx = kept.nonzero(as_tuple=True)
    vals = table["values"][f_idx, s_idx, 0].cpu().numpy()
    out: dict = {}
    for f, row in zip(f_idx.cpu().numpy(), vals):
        b2 = box2d[f]
        out.setdefault(int(frame_ids[f]), {}).setdefault("_", []).append(
            [b2[0], b2[1], b2[2], b2[3], *row.tolist()])
    return out
