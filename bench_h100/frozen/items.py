"""Frustum records -> the model's items and batches.

Frozen from the stage-1 provider's item code,
``frustum_convnet_tpu_torch/data/provider.py`` at commit d5d2a0c
(``FrustumProvider.__getitem__`` with ``RTC`` on and no extra feature, its
``ref_depths``, ``generate_ref``, ``ref_basis`` and ``generate_labels``,
``section_labels`` and ``collate_batch``), made into functions of the
records and the provider's settings: the same draws from ``rng`` in the
same order and the same arithmetic, element by element, done for all items
at once where it is the same for each. The items equal the provider's bit
for bit (``tests/test_h100bench_items.py``).
"""

from __future__ import annotations

import numpy as np

from bench_h100.frozen import geometry as gnp

CLASSES = ("Car", "Pedestrian", "Cyclist")  # KITTI's one-hot order


def ref_depths(strides, max_depth: float):
    """Static per-scale depth grids (``arange(0, MAX, s) + s/2``)."""
    return [np.arange(0, max_depth, s) + s / 2.0 for s in strides]


def section_labels(center, dimension, angle, ref_xyz,
                   fractions=(0.5, 1.0)) -> np.ndarray:
    """+1 inside the ``fractions[0]``-scaled box, -1 (ignore) inside the
    ``fractions[1]``-scaled box, else 0; the nearest section forced
    positive when none lands inside."""
    pos_frac, ign_frac = fractions
    labels = np.zeros(len(ref_xyz), dtype=np.int64)
    inside_ign = gnp.points_in_box3d(ref_xyz, center,
                                     np.asarray(dimension) * ign_frac, angle)
    inside_pos = gnp.points_in_box3d(ref_xyz, center,
                                     np.asarray(dimension) * pos_frac, angle)
    labels[inside_ign] = -1
    labels[inside_pos] = 1
    if inside_pos.sum() == 0:
        d = np.sqrt(((ref_xyz - np.asarray(center)[None]) ** 2).sum(1))
        labels[int(np.argmin(d))] = 1
    return labels


def make_items(rec: dict, P, npoints: int, strides, max_depth: float,
               rng: np.random.Generator, labeled: bool = False,
               random_flip: bool = False, random_shift: bool = False) -> list:
    """The items of every record of ``rec`` (``synthetic.make_frustums``'s
    lists), in order: served items (``labeled`` False, with the detector's
    ``rgb_prob``) or training items with their labels and the provider's
    flip and shift. The draws are the provider's, item by item; the
    arithmetic is its own, done for all items at once where it is the same
    for each."""
    count = len(rec["id"])
    choices, flips, shifts = [], [], []
    for i in range(count):  # the provider's draws, in its order
        n = len(rec["points"][i])
        choices.append(rng.choice(n, npoints, replace=n < npoints))
        if labeled:
            flips.append(bool(random_flip and rng.random() > 0.5))
            shifts.append(rng.standard_normal() if random_shift else None)
    rot = np.pi / 2.0 + np.asarray(rec["frustum_angle"], np.float64)
    c, s = np.cos(rot)[:, None], np.sin(rot)[:, None]
    pts = np.stack([np.asarray(rec["points"][i], np.float32)[choices[i], :3]
                    for i in range(count)])
    x, z = pts[..., 0].copy(), pts[..., 2].copy()
    pts[..., 0] = c * x - s * z  # rotate_pc_along_y, for every item
    pts[..., 2] = s * x + c * z

    box2d = np.stack(rec["box2d"])
    cx = ((box2d[:, 0] + box2d[:, 2]) / 2.0)[:, None]
    cy = ((box2d[:, 1] + box2d[:, 3]) / 2.0)[:, None]
    c_u, c_v, f_u, f_v = P[0, 2], P[1, 2], P[0, 0], P[1, 1]
    b_x, b_y = P[0, 3] / (-f_u), P[1, 3] / (-f_v)

    def unrotated(zs):  # project_image_to_rect of the box center at depths zs
        return (cx - c_u) * zs / f_u + b_x, (cy - c_v) * zs / f_v + b_y

    def rotated(x, y, z):  # rotate_pc_along_y
        return np.stack([c * x - s * z, y, s * x + c * z], axis=-1)

    refs = []
    for zg in ref_depths(strides, max_depth):
        xs, ys = unrotated(zg[None, :])
        refs.append(rotated(xs, ys, np.broadcast_to(zg[None, :], xs.shape)))
    (x0, y0), (x1, y1) = unrotated(0.0), unrotated(1.0)
    ref_dir = rotated(x1 - x0, y1 - y0, np.ones_like(x0))[:, 0]
    ref_off = rotated(x0, y0, np.zeros_like(x0))[:, 0]

    out = []
    for i in range(count):
        one_hot = np.zeros(len(CLASSES), np.float32)
        size_class = CLASSES.index(rec["type"][i])
        one_hot[size_class] = 1.0
        item_refs = [r[i] for r in refs]
        point_set, r_dir, r_off = pts[i], ref_dir[i], ref_off[i]
        item = {"point_cloud": point_set, "rot_angle": np.float32(rot[i])}
        if not labeled:
            item["rgb_prob"] = np.float32(rec["prob"][i])
        else:
            seg = np.asarray(rec["seg"][i], dtype=np.int64)[choices[i]]
            corners = np.asarray(rec["box3d"][i])
            center = gnp.rotate_pc_along_y(((corners[0, :] + corners[6, :]) / 2.0)[None],
                                           rot[i])[0]
            heading = rec["heading"][i] - rot[i]
            size = np.array(rec["size"][i], dtype=np.float32)
            if flips[i]:
                point_set[:, 0] *= -1
                center[0] *= -1
                heading = np.pi - heading
                item_refs = [r.copy() for r in item_refs]
                for r in item_refs:
                    r[:, 0] *= -1
                r_dir, r_off = r_dir.copy(), r_off.copy()
                r_dir[0] *= -1
                r_off[0] *= -1
            if shifts[i] is not None:  # depth jitter along the ray
                l, w, h = size
                dist = np.sqrt(l ** 2 + w ** 2)
                shift = np.clip(shifts[i] * dist * 0.2, -0.5 * dist, 0.5 * dist)
                shift = np.clip(shift + center[2], 0, max_depth) - center[2]
                point_set[:, 2] += shift
                center[2] += shift
            item.update(cls_label=section_labels(center, size, heading, item_refs[1]),
                        box3d_center=center.astype(np.float32),
                        box3d_heading=np.float32(heading), box3d_size=size,
                        size_class=np.int64(size_class), seg_label=seg)
        item.update(refs=[r.astype(np.float32) for r in item_refs],
                    ref_dir=r_dir.astype(np.float32), ref_off=r_off.astype(np.float32),
                    one_hot=one_hot)
        out.append(item)
    return out


def foreground(rec: dict, index: int, refs2_rotated: np.ndarray) -> np.ndarray:
    """The label rule's foreground (+1) sections of a served frustum: its
    object's box, rotated to the center view as the item is, against the
    item's output-scale ladder ``refs2_rotated`` (L, 3)."""
    rot = np.pi / 2.0 + rec["frustum_angle"][index]
    center = gnp.rotate_pc_along_y(np.asarray(rec["center"][index])[None], rot)[0]
    size = np.asarray(rec["size"][index], np.float32)
    labels = section_labels(center, size, rec["ry"][index] - rot,
                            refs2_rotated.astype(np.float64))
    return labels == 1


def collate_batch(items, num_scales: int) -> dict:
    """Stack per-item dicts into the model's batch layout."""
    batch = {}
    for k in items[0].keys():
        if k == "refs":
            batch["refs"] = tuple(
                np.stack([it["refs"][i] for it in items]) for i in range(num_scales))
        else:
            batch[k] = np.stack([np.asarray(it[k]) for it in items])
    return batch
