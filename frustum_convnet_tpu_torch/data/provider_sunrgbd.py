"""SUN-RGBD runtime frustum provider (5-scale ladder, upright camera frame).

Host pipeline with the semantics of
reference `datasets/provider_sample_sunrgbd.py:39-385`:

* single-dict pickles ``sunrgbd_train_aug5x.pickle`` / ``sunrgbd_val.pickle``
  (labeled) and the rgb-detection dict (ref :79-111);
* 5 section ladders back-projected through the box-center pixel via
  K/Rtilt (`image -> upright camera`, ref :283-326);
* rotate-to-center, resample, flip exactly like KITTI; random_shift adds a
  ±0.2 m height jitter on top of the depth shift (ref :225-233);
* section labels on the scale-2 grid with 0.5/1.0 size fractions (identical
  rule to KITTI, ref :265-280);
* ``from_prediction_to_label_format`` returns (tx, ty, tz, l, w, h, ry)
  WITHOUT the ty += h/2 bottom shift (ref :374-385) — SUN boxes are
  centroid-anchored.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from frustum_convnet_tpu_torch.core import geometry_np as gnp
from frustum_convnet_tpu_torch.data import pickle_io
from frustum_convnet_tpu_torch.data.dataset_info import DATASET_INFO
from frustum_convnet_tpu_torch.data.provider import FrustumProvider
from frustum_convnet_tpu_torch.data.sunrgbd.calib import project_image_to_upright_camera


class FrustumSunrgbdProvider:
    name = "provider_sample_sunrgbd"

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
        self.max_depth = float(cfg.DATA.MAX_DEPTH)

        if not overwritten_data_path:
            name = ("sunrgbd_train_aug5x.pickle" if split == "train"
                    else "sunrgbd_val.pickle")
            overwritten_data_path = os.path.join(cfg.DATA.DATA_ROOT, name)
        self.data = pickle_io.read_dict_pickle(overwritten_data_path)
        # normalize key names between labeled / rgb-det dicts
        self._points_key = "input"

    def __len__(self):
        return len(self.data[self._points_key])

    def rot_angle(self, index: int) -> float:
        return np.pi / 2.0 + self.data["frustum_angle"][index]

    def generate_ref(self, box2d, K, Rtilt):
        cx = (box2d[0] + box2d[2]) / 2.0
        cy = (box2d[1] + box2d[3]) / 2.0
        out = []
        for s in self.strides:
            z = np.arange(0, self.max_depth, s) + s / 2.0
            uvd = np.stack([np.full_like(z, cx), np.full_like(z, cy), z], axis=1)
            out.append(project_image_to_upright_camera(uvd, K, Rtilt))
        return out

    generate_labels = staticmethod(FrustumProvider.generate_labels)

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        rot = self.rot_angle(index) if self.rotate_to_center else 0.0

        point_set = np.asarray(self.data["input"][index], dtype=np.float32).copy()
        if self.rotate_to_center:
            point_set = gnp.rotate_pc_along_y(point_set, rot)
        if not self.with_extra_feat:
            point_set = point_set[:, :3]

        n = point_set.shape[0]
        choice = rng.choice(n, self.npoints, replace=n < self.npoints)
        point_set = point_set[choice, :]

        box2d = np.asarray(self.data["box2d"][index])
        K = np.asarray(self.data["calib_K"][index])
        Rtilt = np.asarray(self.data["calib_R"][index])
        refs = self.generate_ref(box2d, K, Rtilt)
        if self.rotate_to_center:
            refs = [gnp.rotate_pc_along_y(r, rot) for r in refs]

        cls_type = self.data["type"][index]
        size_class = self.category_info.CLASSES.index(cls_type)
        one_hot_vec = np.zeros(len(self.category_info.CLASSES), np.float32)
        one_hot_vec[size_class] = 1.0

        if self.from_rgb_detection:
            item = {
                "point_cloud": point_set.astype(np.float32),
                "rot_angle": np.float32(rot),
                "rgb_prob": np.float32(self.data["box2d_prob"][index]),
                "refs": [r.astype(np.float32) for r in refs],
            }
            if self.one_hot:
                item["one_hot"] = one_hot_vec
            return item

        seg = np.asarray(self.data["label"][index], dtype=np.int64)[choice]
        corners = np.asarray(self.data["box3d"][index])
        box3d_center = (corners[0, :] + corners[6, :]) / 2.0
        if self.rotate_to_center:
            box3d_center = gnp.rotate_pc_along_y(box3d_center[None], rot)[0]
            heading = self.data["box3d_heading"][index] - rot
        else:
            heading = self.data["box3d_heading"][index]
        box3d_size = np.asarray(self.data["box3d_size"][index], dtype=np.float32)

        if self.random_flip and rng.random() > 0.5:
            point_set[:, 0] *= -1
            box3d_center = box3d_center.copy()
            box3d_center[0] *= -1
            heading = np.pi - heading
            for r in refs:
                r[:, 0] *= -1

        if self.random_shift:  # depth + height jitter (ref :225-233)
            l, w, h = box3d_size
            dist = np.sqrt(l ** 2 + w ** 2)
            shift = np.clip(rng.standard_normal() * dist * 0.2, -0.5 * dist, 0.5 * dist)
            shift = np.clip(shift + box3d_center[2], 0, self.max_depth) - box3d_center[2]
            point_set[:, 2] += shift
            box3d_center = box3d_center.copy()
            box3d_center[2] += shift
            height_shift = rng.random() * 0.4 - 0.2
            point_set[:, 1] += height_shift
            box3d_center[1] += height_shift

        labels_ref2 = self.generate_labels(box3d_center, box3d_size, heading, refs[1])

        item = {
            "point_cloud": point_set.astype(np.float32),
            "rot_angle": np.float32(rot),
            "refs": [r.astype(np.float32) for r in refs],
            "cls_label": labels_ref2,
            "box3d_center": box3d_center.astype(np.float32),
            "box3d_heading": np.float32(heading),
            "box3d_size": box3d_size,
            "size_class": np.int64(size_class),
            "seg_label": seg,
        }
        if self.one_hot:
            item["one_hot"] = one_hot_vec
        return item


def from_prediction_to_label_format(center, angle, size, rot_angle, ref_center=None):
    """(tx, ty, tz, l, w, h, ry) — centroid-anchored, no bottom shift."""
    l, w, h = size
    ry = angle + rot_angle
    t = gnp.rotate_pc_along_y(np.asarray(center, dtype=np.float64)[None], -rot_angle)[0]
    if ref_center is not None:
        t = t + np.asarray(ref_center)
    return t[0], t[1], t[2], l, w, h, ry
