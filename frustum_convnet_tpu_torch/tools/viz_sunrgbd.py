"""The port's twin of ``tools/viz_sunrgbd.py``, on the port's SUN-RGBD
reader and calibration: the same CLI, figures and PLY files.

SUN-RGBD scene browser: point cloud + 3D box wireframes.

Rebuild of the reference's open3d scene visualizer
(the reference's `sunrgbd/o3d_vis.py`: RGB point cloud, per-object
wireframe line sets, optional ``.ply`` line-set export) without the open3d
dependency: matplotlib 3D rendering for viewing, plus a dependency-free
ASCII-PLY writer for the export path (point cloud with per-vertex color,
and one 12-edge line-set PLY per box — loadable in MeshLab/open3d/blender).

Modes:
* ``--save_dir DIR`` (headless default): writes ``<idx>_scene.png`` per
  frame; with ``--ply`` also ``<idx>_points.ply`` + ``<idx>_box<k>.ply``;
* ``--show``: opens the interactive matplotlib 3D figure per frame and
  blocks until closed (the reference's interactive loop).

Usage:
  python -m frustum_convnet_tpu_torch.tools.viz_sunrgbd --data_root sunrgbd/mysunrgbd [--split training]
      [--idx 1 2 | --max_frames 3] [--save_dir /tmp/viz | --show] [--ply]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from frustum_convnet_tpu_torch.data.sunrgbd.calib import compute_box3d_upright_depth
from frustum_convnet_tpu_torch.data.sunrgbd.object import SunrgbdObjectDataset

# Box edges for the devkit corner ordering (compute_box3d_upright_depth):
# 0-3 top face, 4-7 bottom face (`o3d_vis.py:get_lineset` uses the same 12).
BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]


def write_points_ply(path: str, pts: np.ndarray) -> None:
    """ASCII PLY point cloud; columns 3:6 (rgb in [0,1]) become colors."""
    n = pts.shape[0]
    has_rgb = pts.shape[1] >= 6
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_rgb:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for p in pts:
            line = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if has_rgb:
                r, g, b = (np.clip(p[3:6], 0, 1) * 255).astype(int)
                line += f" {r} {g} {b}"
            f.write(line + "\n")


def write_lineset_ply(path: str, corners: np.ndarray,
                      color=(255, 0, 0)) -> None:
    """ASCII PLY line set for one box — the `o3d.io.write_line_set` analog."""
    assert corners.shape == (8, 3), corners.shape
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write("element vertex 8\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {len(BOX_EDGES)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for c in corners:
            f.write(f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        r, g, b = color
        for a, bb in BOX_EDGES:
            f.write(f"{a} {bb} {r} {g} {b}\n")


def render_scene(pts: np.ndarray, boxes: list[np.ndarray], names: list[str],
                 save_path: str | None, max_points: int = 20000):
    import matplotlib

    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    show = pts
    if show.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(show.shape[0], max_points,
                                              replace=False)
        show = show[sel]
    colors = (np.clip(show[:, 3:6], 0, 1) if show.shape[1] >= 6 else
              show[:, 2:3] @ [[1.0]])
    ax.scatter(show[:, 0], show[:, 1], show[:, 2], s=0.5,
               c=colors if show.shape[1] >= 6 else None, alpha=0.6)
    for corners, name in zip(boxes, names):
        for a, b in BOX_EDGES:
            ax.plot(*zip(corners[a], corners[b]), c="r", linewidth=1.2)
        ax.text(*corners.mean(axis=0), name, color="darkred", fontsize=8)
    ax.set_xlabel("x")
    ax.set_ylabel("y (depth)")
    ax.set_zlabel("z (up)")
    if save_path:
        fig.savefig(save_path, dpi=110, bbox_inches="tight")
        plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", required=True,
                    help="mysunrgbd root containing <split>/{pc,label,calib}")
    ap.add_argument("--split", default="training")
    ap.add_argument("--idx", type=int, nargs="*", default=None,
                    help="explicit 1-based sample ids (default: iterate)")
    ap.add_argument("--max_frames", type=int, default=3)
    ap.add_argument("--save_dir", default=None)
    ap.add_argument("--show", action="store_true",
                    help="interactive: block on each frame's 3D figure")
    ap.add_argument("--ply", action="store_true",
                    help="also export points + per-box line sets as ASCII PLY")
    args = ap.parse_args(argv)
    if not args.show and not args.save_dir:
        args.save_dir = "viz_out"

    ds = SunrgbdObjectDataset(args.data_root, split=args.split)
    indices = args.idx if args.idx else list(range(1, args.max_frames + 1))
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    for i in indices:
        pts = ds.get_pointcloud(i)  # upright-depth frame, cols 3:6 = rgb
        objects = ds.get_label_objects(i)
        boxes = [compute_box3d_upright_depth(o) for o in objects]
        names = [o.classname for o in objects]
        print(f"sample {i:06d}: {len(objects)} objects, "
              f"{pts.shape[0]} points", flush=True)

        def path(kind):
            return (os.path.join(args.save_dir, f"{i:06d}_{kind}")
                    if args.save_dir else None)

        render_scene(pts, boxes, names,
                     path("scene.png") if args.save_dir else None)
        if args.show:
            import matplotlib.pyplot as plt
            plt.show()
        if args.ply and args.save_dir:
            write_points_ply(path("points.ply"), pts)
            for k, corners in enumerate(boxes):
                write_lineset_ply(path(f"box{k}.ply"), corners)
    if args.save_dir:
        print(f"wrote scene renders to {args.save_dir}")


if __name__ == "__main__":
    main()
