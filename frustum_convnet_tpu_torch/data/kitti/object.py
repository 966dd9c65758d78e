"""Raw KITTI dataset access (images / calib / labels / velodyne).

Fresh equivalent of reference `kitti/kitti_object.py:22-62` — path
layout ``<root>/<training|testing>/{image_2,calib,label_2,velodyne}`` with
6-digit frame ids.
"""

from __future__ import annotations

import os

import numpy as np

from frustum_convnet_tpu_torch.data.kitti.calib import Calibration, load_velo_scan, read_label


class KittiObjectDataset:
    def __init__(self, root: str, split: str = "training"):
        assert split in ("training", "testing"), split
        self.root = root
        self.split = split
        self.split_dir = os.path.join(root, split)
        self.image_dir = os.path.join(self.split_dir, "image_2")
        self.calib_dir = os.path.join(self.split_dir, "calib")
        self.label_dir = os.path.join(self.split_dir, "label_2")
        self.lidar_dir = os.path.join(self.split_dir, "velodyne")

    def __len__(self) -> int:
        # sample count from the image dir (ref kitti/kitti_object.py
        # num_samples is split-hardcoded; counting files also covers
        # synthetic miniatures)
        import glob

        return len(glob.glob(os.path.join(self.image_dir, "*.png")))

    def get_calibration(self, idx: int) -> Calibration:
        return Calibration(os.path.join(self.calib_dir, f"{idx:06d}.txt"))

    def get_label_objects(self, idx: int):
        assert self.split == "training"
        return read_label(os.path.join(self.label_dir, f"{idx:06d}.txt"))

    def get_lidar(self, idx: int) -> np.ndarray:
        return load_velo_scan(os.path.join(self.lidar_dir, f"{idx:06d}.bin"))

    def get_image_size(self, idx: int):
        """(height, width) without decoding the full image when possible."""
        from PIL import Image

        with Image.open(os.path.join(self.image_dir, f"{idx:06d}.png")) as im:
            return im.height, im.width

    def get_image(self, idx: int) -> np.ndarray:
        from PIL import Image

        with Image.open(os.path.join(self.image_dir, f"{idx:06d}.png")) as im:
            return np.asarray(im)


class KittiVideoDataset:
    """Raw KITTI video sequence access (demo/visualization path).

    Equivalent of reference `kitti/kitti_object.py:71-102`: sorted
    frame images + velodyne sweeps from a raw-video dump, with ONE
    sequence-level calibration read from the video calib directory
    (``calib_cam_to_cam.txt`` + ``calib_velo_to_cam.txt``).
    """

    def __init__(self, img_dir: str, lidar_dir: str, calib_dir: str):
        self.calib = Calibration.from_video(calib_dir)
        self.img_filenames = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir))
        self.lidar_filenames = sorted(
            os.path.join(lidar_dir, f) for f in os.listdir(lidar_dir))
        self.num_samples = len(self.img_filenames)

    def __len__(self) -> int:
        return self.num_samples

    def get_image(self, idx: int) -> np.ndarray:
        from PIL import Image

        with Image.open(self.img_filenames[idx]) as im:
            return np.asarray(im)

    def get_lidar(self, idx: int) -> np.ndarray:
        return load_velo_scan(self.lidar_filenames[idx])

    def get_calibration(self, idx: int = 0) -> Calibration:
        return self.calib
