"""Raw SUN-RGBD dataset access (``mysunrgbd`` layout).

Fresh equivalent of reference `sunrgbd/sunrgbd_object.py:11-51`:
``<root>/<split>/{image/%06d.jpg, calib/%06d.txt, pc/%06d.(mat|npy),
depth/, label/%06d.txt}``, 1-based ids, train split = samples 5051..10335 of
the toolbox ordering (val = 1..5050).
"""

from __future__ import annotations

import os

import numpy as np

from frustum_convnet_tpu_torch.data.sunrgbd.calib import (SunCalibration,
                                                    load_depth_points,
                                                    read_sunrgbd_label)


class SunrgbdObjectDataset:
    def __init__(self, root_dir: str, split: str = "training"):
        self.root_dir = root_dir
        self.split = split
        self.split_dir = os.path.join(root_dir, split)
        self.image_dir = os.path.join(self.split_dir, "image")
        self.calib_dir = os.path.join(self.split_dir, "calib")
        self.pc_dir = os.path.join(self.split_dir, "pc")
        self.depth_dir = os.path.join(self.split_dir, "depth")
        self.label_dir = os.path.join(self.split_dir, "label")

    def get_calibration(self, idx: int) -> SunCalibration:
        return SunCalibration(os.path.join(self.calib_dir, f"{idx:06d}.txt"))

    def get_pointcloud(self, idx: int) -> np.ndarray:
        for ext in (".npy", ".mat", ".txt"):
            p = os.path.join(self.pc_dir, f"{idx:06d}{ext}")
            if os.path.exists(p):
                return load_depth_points(p)
        raise FileNotFoundError(f"no point cloud for sample {idx} in {self.pc_dir}")

    def get_label_objects(self, idx: int):
        return read_sunrgbd_label(os.path.join(self.label_dir, f"{idx:06d}.txt"))

    def get_image(self, idx: int) -> np.ndarray:
        from PIL import Image

        with Image.open(os.path.join(self.image_dir, f"{idx:06d}.jpg")) as im:
            return np.asarray(im)
