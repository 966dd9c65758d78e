"""KITTI runtime frustum provider: pickles -> static-shaped model batches.

Host-side numpy pipeline with the semantics of the reference's
``ProviderDataset`` (reference `datasets/provider_sample.py:39-397`):

* pickle path template ``frustum_{caronly|pedcyc|carpedcyc}_{split}
  [_rgb_detection].pickle`` under ``DATA.DATA_ROOT`` (ref :65-81);
* per-item: rotate points/refs/box to the frustum center view
  (rot angle = pi/2 + frustum_angle, ref :329-332), resample to a fixed
  point count (with replacement iff short, ref :164-171), build the
  4/5-stride section-center ladder through the 2D-box center pixel
  (ref :291-327), label sections on the scale-2 grid (+1 inside half-size
  box, -1 inside full box, nearest forced +1; ref :272-289), optional
  random flip / depth shift augmentation (ref :224-243);
* output is channels-last (N, C) / (M, 3) numpy — the TPU model's layout —
  where the reference emits torch (C, N) tensors.

All shapes are static given the config, so batches feed a single jitted
SPMD step with no recompilation.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from frustum_convnet_tpu_torch.core import geometry_np as gnp
from frustum_convnet_tpu_torch.data import pickle_io
from frustum_convnet_tpu_torch.data.dataset_info import DATASET_INFO


def default_pickle_path(cfg, split: str, from_rgb_detection: bool) -> str:
    """Reference path template (`provider_sample.py:65-81`)."""
    if cfg.DATA.CAR_ONLY:
        prefix = "frustum_caronly"
    elif cfg.DATA.PEOPLE_ONLY:
        prefix = "frustum_pedcyc"
    else:
        prefix = "frustum_carpedcyc"
    suffix = "_rgb_detection" if from_rgb_detection else ""
    return os.path.join(cfg.DATA.DATA_ROOT, f"{prefix}_{split}{suffix}.pickle")


def section_labels(center, dimension, angle, ref_xyz,
                   fractions=(0.5, 1.0)) -> np.ndarray:
    """Per-section cls labels: +1 inside the ``fractions[0]``-scaled box,
    -1 (ignore) inside the ``fractions[1]``-scaled box, else 0; nearest
    section forced positive when none land inside. The single source of the
    rule for all providers and fixtures — stage 1 uses (0.5, 1.0)
    (ref `provider_sample.py:272-289`), the refine stage (0.3, 0.6)
    (ref `provider_sample_refine.py:318-334`).
    """
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


class FrustumProvider:
    """Stage-1 KITTI provider ('provider_sample' in the registry)."""

    name = "provider_sample"

    def __init__(self, cfg, split: str, random_flip: bool = False,
                 random_shift: bool = False, one_hot: bool = True,
                 from_rgb_detection: bool = False,
                 overwritten_data_path: str = "",
                 extend_from_det: bool = False):
        self.cfg = cfg
        self.split = split
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

        path = overwritten_data_path or default_pickle_path(cfg, split, from_rgb_detection)
        fields = (pickle_io.KITTI_RGBDET_FIELDS if from_rgb_detection
                  else pickle_io.KITTI_LABELED_FIELDS)
        self.data = pickle_io.read_stream_pickle(path, fields)
        if extend_from_det and not from_rgb_detection:
            # split on the extension (a DATA_ROOT containing '.' must not
            # corrupt the path; ref `provider_sample.py:110-126`)
            root, ext_suffix = os.path.splitext(path)
            ext = f"{root}_det{ext_suffix}"
            extra = pickle_io.read_stream_pickle(ext, fields)
            for k in fields:
                self.data[k] = list(self.data[k]) + list(extra[k])

    def __len__(self):
        return len(self.data["points"])

    # ------------------------------------------------------------------
    def rot_angle(self, index: int) -> float:
        """pi/2 + frustum_angle (ref :329-332)."""
        return np.pi / 2.0 + self.data["frustum_angle"][index]

    def ref_depths(self) -> List[np.ndarray]:
        """Static per-scale depth grids (ref :296 `arange(0, MAX, s) + s/2`)."""
        return [np.arange(0, self.max_depth, s) + s / 2.0 for s in self.strides]

    def generate_ref(self, box2d, P) -> List[np.ndarray]:
        """Section-center ladders through the box-center pixel (ref :291-327)."""
        cx = (box2d[0] + box2d[2]) / 2.0
        cy = (box2d[1] + box2d[3]) / 2.0
        out = []
        for z in self.ref_depths():
            uvd = np.stack([np.full_like(z, cx), np.full_like(z, cy), z], axis=1)
            out.append(gnp.project_image_to_rect(uvd, P))
        return out

    def ref_basis(self, box2d, P):
        """(dir, off) of the affine ladder ``ref(z) = z * dir + off``.

        Pinhole back-projection through the fixed box-center pixel is affine
        in depth, so the whole ladder is carried by 6 floats per frustum —
        the inference driver rebuilds the section ladders ON DEVICE from
        these plus the static depth grids, cutting ~25% of the host->device
        bytes (BENCH_NOTES.md). Rotation/flip are linear and commute with
        the affine form.
        """
        cx = (box2d[0] + box2d[2]) / 2.0
        cy = (box2d[1] + box2d[3]) / 2.0
        pts = gnp.project_image_to_rect(
            np.array([[cx, cy, 0.0], [cx, cy, 1.0]]), P)
        return pts[1] - pts[0], pts[0]

    @staticmethod
    def generate_labels(center, dimension, angle, ref_xyz) -> np.ndarray:
        """+1 inside half-size box, -1 inside full box, else 0 (ref :272-289)."""
        return section_labels(center, dimension, angle, ref_xyz,
                              fractions=(0.5, 1.0))

    # ------------------------------------------------------------------
    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng()
        rot = self.rot_angle(index) if self.rotate_to_center else 0.0

        point_set = np.asarray(self.data["points"][index], dtype=np.float32)
        if self.rotate_to_center:
            point_set = gnp.rotate_pc_along_y(point_set, rot)
        if not self.with_extra_feat:
            point_set = point_set[:, :3]

        # resample to fixed count; replacement only when short (ref :164-171)
        n = point_set.shape[0]
        choice = rng.choice(n, self.npoints, replace=n < self.npoints)
        point_set = point_set[choice, :]

        box2d = np.asarray(self.data["box2d"][index])
        P = np.asarray(self.data["calib"][index]["P2"]).reshape(3, 4)
        refs = self.generate_ref(box2d, P)
        ref_dir, ref_off = self.ref_basis(box2d, P)
        if self.rotate_to_center:
            refs = [gnp.rotate_pc_along_y(r, rot) for r in refs]
            ref_dir = gnp.rotate_pc_along_y(ref_dir[None], rot)[0]
            ref_off = gnp.rotate_pc_along_y(ref_off[None], rot)[0]

        cls_type = self.data["type"][index]
        size_class = self.category_info.CLASSES.index(cls_type)
        one_hot_vec = np.zeros(len(self.category_info.CLASSES), np.float32)
        one_hot_vec[size_class] = 1.0

        if self.from_rgb_detection:
            item = {
                "point_cloud": point_set.astype(np.float32),
                "rot_angle": np.float32(rot),
                "rgb_prob": np.float32(self.data["prob"][index]),
                "refs": [r.astype(np.float32) for r in refs],
                "ref_dir": ref_dir.astype(np.float32),
                "ref_off": ref_off.astype(np.float32),
            }
            if self.one_hot:
                item["one_hot"] = one_hot_vec
            return item

        # ----- labels
        seg = np.asarray(self.data["seg"][index], dtype=np.int64)[choice]
        corners = np.asarray(self.data["box3d"][index])
        box3d_center = (corners[0, :] + corners[6, :]) / 2.0
        if self.rotate_to_center:
            box3d_center = gnp.rotate_pc_along_y(box3d_center[None], rot)[0]
            heading = self.data["heading"][index] - rot
        else:
            heading = self.data["heading"][index]
        box3d_size = np.array(self.data["size"][index], dtype=np.float32)

        if self.random_flip and rng.random() > 0.5:  # (ref :224-235)
            point_set[:, 0] *= -1
            box3d_center = box3d_center.copy()
            box3d_center[0] *= -1
            heading = np.pi - heading
            for r in refs:
                r[:, 0] *= -1
            ref_dir = ref_dir.copy()
            ref_off = ref_off.copy()
            ref_dir[0] *= -1
            ref_off[0] *= -1

        if self.random_shift:  # depth jitter along the ray (ref :237-243)
            l, w, h = box3d_size
            dist = np.sqrt(l ** 2 + w ** 2)
            shift = np.clip(rng.standard_normal() * dist * 0.2, -0.5 * dist, 0.5 * dist)
            shift = np.clip(shift + box3d_center[2], 0, self.max_depth) - box3d_center[2]
            point_set[:, 2] += shift
            box3d_center = box3d_center.copy()
            box3d_center[2] += shift

        labels_ref2 = self.generate_labels(box3d_center, box3d_size, heading, refs[1])

        item = {
            "point_cloud": point_set.astype(np.float32),
            "rot_angle": np.float32(rot),
            "refs": [r.astype(np.float32) for r in refs],
            "ref_dir": ref_dir.astype(np.float32),
            "ref_off": ref_off.astype(np.float32),
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
    """Decode a model box back to KITTI label values (ref :375-387).

    Returns (h, w, l, tx, ty, tz, ry); ty is shifted to the box bottom.
    """
    l, w, h = size
    ry = angle + rot_angle
    tx, ty, tz = gnp.rotate_pc_along_y(np.asarray(center, dtype=np.float64)[None], -rot_angle)[0]
    if ref_center is not None:
        tx, ty, tz = tx + ref_center[0], ty + ref_center[1], tz + ref_center[2]
    ty += h / 2.0
    return h, w, l, tx, ty, tz, ry


def from_prediction_to_label_format_batch(centers, angles, sizes, rot_angles,
                                          ref_centers=None):
    """Vectorized decode of D boxes to KITTI label values (ref :375-387).

    centers (D, 3), angles (D,), sizes (D, 3 lwh), rot_angles (D,),
    ref_centers (D, 3) or None. Returns (D, 7) = [h, w, l, tx, ty, tz, ry];
    ty is shifted to the box bottom. Matches the scalar
    ``from_prediction_to_label_format`` per row.
    """
    centers = np.asarray(centers, dtype=np.float64)
    sizes = np.asarray(sizes, dtype=np.float64)
    angles = np.asarray(angles, dtype=np.float64)
    rot_angles = np.asarray(rot_angles, dtype=np.float64)
    d = len(centers)

    ry = angles + rot_angles
    # de-rotate each center by its own -rot_angle about the y axis
    # (x' = cos*x - sin*z ; z' = sin*x + cos*z, the reference convention)
    cos, sin = np.cos(-rot_angles), np.sin(-rot_angles)
    tx = cos * centers[:, 0] - sin * centers[:, 2]
    tz = sin * centers[:, 0] + cos * centers[:, 2]
    ty = centers[:, 1].copy()
    if ref_centers is not None:
        ref_centers = np.asarray(ref_centers, dtype=np.float64)
        tx, ty, tz = tx + ref_centers[:, 0], ty + ref_centers[:, 1], tz + ref_centers[:, 2]
    out = np.empty((d, 7), dtype=np.float64)
    out[:, 0] = sizes[:, 2]  # h
    out[:, 1] = sizes[:, 1]  # w
    out[:, 2] = sizes[:, 0]  # l
    out[:, 3] = tx
    out[:, 4] = ty + sizes[:, 2] / 2.0
    out[:, 5] = tz
    out[:, 6] = ry
    return out


compute_alpha = gnp.compute_alpha


def collate_batch(items: List[Dict], num_scales: int) -> Dict[str, np.ndarray]:
    """Stack per-item dicts into the model's batch layout."""
    batch = {}
    keys = items[0].keys()
    for k in keys:
        if k == "refs":
            batch["refs"] = tuple(
                np.stack([it["refs"][i] for it in items]) for i in range(num_scales)
            )
        else:
            batch[k] = np.stack([np.asarray(it[k]) for it in items])
    return batch
