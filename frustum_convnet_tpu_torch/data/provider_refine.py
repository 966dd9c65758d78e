"""Refinement-stage provider: frustums re-cut from stage-1 predicted boxes.

Host pipeline with the semantics of the reference refine provider
(reference `datasets/provider_sample_refine.py:39-470`):

* normalization is translate-to-pred-box-center then rotate by the pred box
  **angle** (not the frustum angle; ref ``normalize_input``/:141-169);
* the section ladder runs along the 3D line through the front/back face
  centroids of the rotated pred box, over its z extent (ref :336-385);
* section labels use 0.3 / 0.6 size fractions (ref :318-334);
* random shift is stride[0]-scaled (clip(randn*0.1*diag, ±2*s1), ref :280-285);
* items carry ``ref_center``/``rot_angle`` = pred box center/angle so decode
  can restore the global frame (ref ``from_prediction_to_label_format``
  :422-431).

TPU redesign of the dynamic part: the reference pads ref counts to the batch
max inside ``collate_fn`` (dynamic shapes, ref :388-419). Here every sample
uses a *fixed* ladder of ``ceil(DATA.REFINE_MAX_SPAN / stride)`` sections per
scale: ladders shorter than the span are edge-padded in position, and the
padded sections' labels are set to -1 (ignore) so they contribute no loss —
a deliberate improvement over edge-padding labels (which duplicates
positives) while keeping shapes static across the entire run.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from frustum_convnet_tpu_torch.core import geometry_np as gnp
from frustum_convnet_tpu_torch.data import pickle_io
from frustum_convnet_tpu_torch.data.dataset_info import DATASET_INFO
from frustum_convnet_tpu_torch.data.provider import default_pickle_path


class FrustumRefineProvider:
    name = "provider_sample_refine"

    def __init__(self, cfg, split: str, random_flip: bool = False,
                 random_shift: bool = False, one_hot: bool = True,
                 from_rgb_detection: bool = False,
                 overwritten_data_path: str = "",
                 extend_from_det: bool = False):
        self.cfg = cfg
        self.npoints = cfg.DATA.NUM_SAMPLES
        self.random_flip = random_flip
        self.random_shift = random_shift
        self.one_hot = one_hot
        self.from_rgb_detection = from_rgb_detection
        self.category_info = DATASET_INFO[cfg.DATA.DATASET_NAME]
        self.rotate_to_center = cfg.DATA.RTC
        self.with_extra_feat = cfg.DATA.WITH_EXTRA_FEAT
        self.strides = list(cfg.DATA.STRIDE)
        self.max_span = float(cfg.DATA.REFINE_MAX_SPAN)
        self.num_refs = [int(np.ceil(self.max_span / s - 1e-9)) for s in self.strides]

        path = overwritten_data_path or default_pickle_path(cfg, split, from_rgb_detection)
        fields = (pickle_io.REFINE_RGBDET_FIELDS if from_rgb_detection
                  else pickle_io.REFINE_LABELED_FIELDS)
        self.data = pickle_io.read_stream_pickle(path, fields)
        if extend_from_det and not from_rgb_detection:
            # append the stage-1-detection-assigned frustums, reference
            # behavior `provider_sample_refine.py:118-135` (the `_det`
            # pickle from `prepare_refine --gen_val_det`); split on the
            # extension so a dotted DATA_ROOT can't corrupt the path
            root, ext_suffix = os.path.splitext(path)
            extra = pickle_io.read_stream_pickle(f"{root}_det{ext_suffix}",
                                                 fields)
            for k in fields:
                self.data[k] = list(self.data[k]) + list(extra[k])

    def __len__(self):
        return len(self.data["points"])

    # ------------------------------------------------------------------
    @staticmethod
    def _rotate_frame(center, angle, ref_center, ref_angle):
        """Express a (center, angle) box in the pred-box frame (ref :135-147)."""
        c = np.asarray(center, dtype=np.float64) - np.asarray(ref_center)
        c = gnp.rotate_pc_along_y(c[None], ref_angle)[0]
        return c, angle - ref_angle

    def generate_ref(self, pred_corners: np.ndarray) -> List[np.ndarray]:
        """Fixed-count ladders along the pred box axis (ref :336-385 + static pad).

        The reference spans [zmin, zmax) of the rotated box; we generate the
        same positions, then edge-pad (or crop) to the static count. Returns
        (refs per scale, valid counts per scale).
        """
        cz = ((pred_corners[0] + pred_corners[6]) / 2.0)[2]
        z1 = pred_corners[:, 2].min()
        z2 = pred_corners[:, 2].max()
        front = pred_corners[pred_corners[:, 2] < cz]
        back = pred_corners[pred_corners[:, 2] > cz]
        c1 = front.mean(0)
        c2 = back.mean(0)
        delta = c2 - c1
        dz = delta[2] if abs(delta[2]) > 1e-9 else 1e-9

        refs, valids = [], []
        for s, m in zip(self.strides, self.num_refs):
            z = np.arange(z1, z2, s) + s / 2.0
            x = (z - c1[2]) / dz * delta[0] + c1[0]
            y = (z - c1[2]) / dz * delta[1] + c1[1]
            ladder = np.stack([x, y, z], axis=1)
            n = len(ladder)
            if n >= m:
                ladder, n = ladder[:m], m
            elif n == 0:
                ladder = np.zeros((m, 3))
                n = 0
            else:
                ladder = np.concatenate(
                    [ladder, np.repeat(ladder[-1:], m - n, axis=0)], axis=0)
            refs.append(ladder)
            valids.append(n)
        return refs, valids

    @staticmethod
    def generate_labels(center, dimension, angle, ref_xyz) -> np.ndarray:
        """+1 inside 0.3x box, -1 inside 0.6x, else 0 (ref :318-334)."""
        from frustum_convnet_tpu_torch.data.provider import section_labels
        return section_labels(center, dimension, angle, ref_xyz,
                              fractions=(0.3, 0.6))

    # ------------------------------------------------------------------
    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()

        point_set = np.asarray(self.data["points"][index], dtype=np.float32).copy()
        pred_corners_global = np.asarray(self.data["pred_box3d"][index])
        pred_center = (pred_corners_global[0] + pred_corners_global[6]) / 2.0
        pred_angle = float(self.data["pred_box3d_angle"][index])
        pred_size = np.asarray(self.data["pred_box3d_size"][index], dtype=np.float64)

        cls_type = self.data["type"][index]
        size_class = self.category_info.CLASSES.index(cls_type)
        one_hot_vec = np.zeros(len(self.category_info.CLASSES), np.float32)
        one_hot_vec[size_class] = 1.0

        if self.rotate_to_center:
            point_set[:, :3] = gnp.rotate_pc_along_y(
                point_set[:, :3] - pred_center[None], pred_angle)
            pred_center_rot, pred_angle_rot = np.zeros(3), 0.0
        else:
            pred_center_rot, pred_angle_rot = pred_center, pred_angle
        if not self.with_extra_feat:
            point_set = point_set[:, :3]

        n = point_set.shape[0]
        choice = rng.choice(n, self.npoints, replace=n < self.npoints)
        point_set = point_set[choice, :]

        pred_corners = gnp.box3d_corners(pred_center_rot, pred_size, pred_angle_rot)
        refs, valids = self.generate_ref(pred_corners)

        rot_angle = pred_angle if self.rotate_to_center else 0.0
        ref_center = pred_center if self.rotate_to_center else np.zeros(3)

        if self.from_rgb_detection:
            item = {
                "point_cloud": point_set.astype(np.float32),
                "rot_angle": np.float32(rot_angle),
                "ref_center": ref_center.astype(np.float32),
                "rgb_prob": np.float32(self.data["prob"][index]),
                "refs": [r.astype(np.float32) for r in refs],
            }
            if self.one_hot:
                item["one_hot"] = one_hot_vec
            return item

        # ----- labels
        gt_corners = np.asarray(self.data["box3d"][index])
        gt_center = (gt_corners[0] + gt_corners[6]) / 2.0
        heading = float(self.data["heading"][index])
        if self.rotate_to_center:
            gt_center, heading = self._rotate_frame(
                gt_center, heading, pred_center, pred_angle)
        box3d_size = np.asarray(self.data["size"][index], dtype=np.float32)

        if self.random_flip and rng.random() > 0.5:
            point_set[:, 0] *= -1
            gt_center = gt_center.copy()
            gt_center[0] *= -1
            heading = np.pi - heading
            for r in refs:
                r[:, 0] *= -1

        if self.random_shift:  # (ref :280-285)
            s1 = self.strides[0]
            l, w, h = box3d_size
            dist = np.sqrt(l ** 2 + w ** 2)
            shift = np.clip(rng.standard_normal() * dist * 0.1, -2 * s1, 2 * s1)
            point_set[:, 2] += shift
            gt_center = gt_center.copy()
            gt_center[2] += shift

        # label only the valid (unpadded) ladder so the nearest-forced positive
        # cannot land on a padded slot; padding is ignore (-1)
        n_valid = max(valids[1], 1)
        labels = np.full(len(refs[1]), -1, dtype=np.int64)
        labels[:n_valid] = self.generate_labels(
            gt_center, box3d_size, heading, refs[1][:n_valid])

        item = {
            "point_cloud": point_set.astype(np.float32),
            "rot_angle": np.float32(rot_angle),
            "ref_center": ref_center.astype(np.float32),
            "refs": [r.astype(np.float32) for r in refs],
            "cls_label": labels,
            "box3d_center": gt_center.astype(np.float32),
            "box3d_heading": np.float32(heading),
            "box3d_size": box3d_size,
            "size_class": np.int64(size_class),
        }
        if self.one_hot:
            item["one_hot"] = one_hot_vec
        return item


def from_prediction_to_label_format(center, angle, size, rot_angle, ref_center):
    """Decode to KITTI label values; always restores the pred-box frame
    (ref `provider_sample_refine.py:422-431`)."""
    l, w, h = size
    ry = angle + rot_angle
    t = gnp.rotate_pc_along_y(np.asarray(center, dtype=np.float64)[None], -rot_angle)[0]
    tx, ty, tz = t + np.asarray(ref_center)
    ty += h / 2.0
    return h, w, l, tx, ty, tz, ry
