"""The port's twin of ``tools/viz_kitti.py``, on the port's KITTI reader
and ``utils/visualize.py``: the same CLI and figures.

Interactive / batch KITTI frame browser.

Rebuild of the reference's dataset visualization loop
(the reference's `kitti/draw_util.py:151-172`: iterate frames, show image
with 2D + projected-3D GT boxes, the LiDAR sweep with boxes, and LiDAR
projected on the image, pausing between frames) on the matplotlib
renderers in ``frustum_convnet_tpu_torch/utils/visualize.py`` — no cv2/mayavi.

Two modes:
* ``--save_dir DIR`` (default-friendly for headless boxes): writes
  ``<idx>_{boxes,lidar3d,lidar_img}.png`` per frame;
* ``--show``: opens the three figures per frame and blocks until closed
  (the interactive equivalent of the reference's ``input()`` pauses).

Usage:
  python -m frustum_convnet_tpu_torch.tools.viz_kitti --data_root data/kitti [--split training]
      [--idx 0 7 42 | --max_frames 5] [--save_dir /tmp/viz | --show]
"""

from __future__ import annotations

import argparse
import os

from frustum_convnet_tpu_torch.data.kitti.object import KittiObjectDataset
from frustum_convnet_tpu_torch.utils import visualize as viz


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", required=True,
                    help="KITTI root containing training/{image_2,label_2,...}")
    ap.add_argument("--split", default="training")
    ap.add_argument("--idx", type=int, nargs="*", default=None,
                    help="explicit frame indices (default: iterate)")
    ap.add_argument("--max_frames", type=int, default=5)
    ap.add_argument("--save_dir", default=None)
    ap.add_argument("--show", action="store_true",
                    help="interactive: block on each frame's figures")
    args = ap.parse_args(argv)
    if not args.show and not args.save_dir:
        args.save_dir = "viz_out"

    ds = KittiObjectDataset(args.data_root, split=args.split)
    indices = args.idx if args.idx else list(range(min(len(ds), args.max_frames)))
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    for i in indices:
        objects = ds.get_label_objects(i)
        img = ds.get_image(i)
        calib = ds.get_calibration(i)
        pc_velo = ds.get_lidar(i)[:, 0:3]
        print(f"frame {i:06d}: {len(objects)} objects, "
              f"{pc_velo.shape[0]} points, image {img.shape[1]}x{img.shape[0]}")

        def path(kind):
            return (os.path.join(args.save_dir, f"{i:06d}_{kind}.png")
                    if args.save_dir else None)

        viz.show_image_with_boxes(img, objects, calib, save_path=path("boxes"))
        viz.show_lidar_with_boxes(pc_velo, objects, calib,
                                  save_path=path("lidar3d"))
        viz.show_lidar_on_image(pc_velo, img, calib,
                                save_path=path("lidar_img"))
        if args.show:
            import matplotlib.pyplot as plt
            plt.show()  # blocks until the user closes the frame's figures
    if args.save_dir:
        print(f"wrote figures to {args.save_dir}")


if __name__ == "__main__":
    main()
