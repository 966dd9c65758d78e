"""SUN-RGBD frustum records -> the model's served items.

Frozen from the SUN-RGBD provider's item code,
``frustum_convnet_tpu_torch/data/provider_sunrgbd.py`` at commit 63f8e5d
(``FrustumSunrgbdProvider.__getitem__`` on the rgb-detection path, with
``RTC`` on and no extra feature, and its ``generate_ref``), with the
calibration's ``project_image_to_upright_camera`` from
``data/sunrgbd/calib.py`` (``sunrgbd_synthetic.image_to_upright_camera``),
made into a function of the records and the provider's settings: the same
draws from ``rng`` in the same order and the same arithmetic, item by item.
The items equal the provider's bit for bit
(``tests/test_h100bench_sunrgbd.py``). ``foreground`` is the provider's
section-label rule on the labelled path (``generate_labels``, KITTI's
``section_labels``) for the detected object's box.
"""

from __future__ import annotations

import numpy as np

from bench_h100.frozen import geometry as gnp
from bench_h100.frozen.items import section_labels
from bench_h100.frozen.sunrgbd_synthetic import CLASSES, image_to_upright_camera


def ref_ladders(box2d, K, Rtilt, strides, max_depth: float) -> list:
    """The 5 section ladders (M_i, 3) through the box center's pixel, in the
    upright camera (``generate_ref``)."""
    cx = (box2d[0] + box2d[2]) / 2.0
    cy = (box2d[1] + box2d[3]) / 2.0
    out = []
    for s in strides:
        z = np.arange(0, max_depth, s) + s / 2.0
        uvd = np.stack([np.full_like(z, cx), np.full_like(z, cy), z], axis=1)
        out.append(image_to_upright_camera(uvd, K, Rtilt))
    return out


def make_items(rec: dict, npoints: int, strides, max_depth: float,
               rng: np.random.Generator) -> list:
    """The served items of every record of ``rec``
    (``sunrgbd_synthetic.make_frustums``'s lists), in order, drawing from
    ``rng`` as the provider does."""
    out = []
    for i in range(len(rec["id"])):
        rot = np.pi / 2.0 + rec["frustum_angle"][i]
        point_set = np.asarray(rec["input"][i], dtype=np.float32).copy()
        point_set = gnp.rotate_pc_along_y(point_set, rot)[:, :3]
        n = point_set.shape[0]
        point_set = point_set[rng.choice(n, npoints, replace=n < npoints), :]
        refs = ref_ladders(np.asarray(rec["box2d"][i]), np.asarray(rec["calib_K"][i]),
                           np.asarray(rec["calib_R"][i]), strides, max_depth)
        refs = [gnp.rotate_pc_along_y(r, rot) for r in refs]
        one_hot = np.zeros(len(CLASSES), np.float32)
        one_hot[CLASSES.index(rec["type"][i])] = 1.0
        out.append({"point_cloud": point_set.astype(np.float32),
                    "rot_angle": np.float32(rot),
                    "rgb_prob": np.float32(rec["box2d_prob"][i]),
                    "refs": [r.astype(np.float32) for r in refs],
                    "one_hot": one_hot})
    return out


def foreground(rec: dict, index: int, refs2_rotated: np.ndarray) -> np.ndarray:
    """The label rule's foreground (+1) sections of a served frustum: its
    object's box, rotated to the center view as the item is, against the
    item's output-scale ladder ``refs2_rotated`` (L, 3)."""
    rot = np.pi / 2.0 + rec["frustum_angle"][index]
    center = gnp.rotate_pc_along_y(np.asarray(rec["center"][index])[None], rot)[0]
    labels = section_labels(center, np.asarray(rec["size"][index], np.float32),
                            rec["heading"][index] - rot, refs2_rotated.astype(np.float64))
    return labels == 1
