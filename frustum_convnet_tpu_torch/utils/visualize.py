"""Debug visualization: 3D sanity plots of frustums, section ladders, boxes.

Equivalent of the reference's `datasets/check_utils.py:45-108` matplotlib
overlays (not on the training path). Gated on matplotlib availability; every
function returns the figure so callers can save instead of show.
"""

from __future__ import annotations

import numpy as np


def _require_mpl():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt  # noqa: F401

        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("matplotlib is required for visualization") from e


_BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_box3d(ax, corners: np.ndarray, color="g"):
    for a, b in _BOX_EDGES:
        ax.plot(*zip(corners[a], corners[b]), color=color, linewidth=1)


def check_box_frustum(points: np.ndarray, refs, box_corners: np.ndarray,
                      labels: np.ndarray | None = None, save_path: str | None = None):
    """Point cloud + section ladders + GT box in one 3D axes."""
    plt = _require_mpl()
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(points[:, 0], points[:, 2], -points[:, 1], s=1, c="gray", alpha=0.4)
    colors = ["C0", "C1", "C2", "C3", "C4"]
    for i, r in enumerate(refs):
        ax.scatter(r[:, 0], r[:, 2], -r[:, 1], s=6, c=colors[i % 5], label=f"scale {i + 1}")
    c = np.asarray(box_corners)
    for a, b in _BOX_EDGES:
        ax.plot([c[a, 0], c[b, 0]], [c[a, 2], c[b, 2]], [-c[a, 1], -c[b, 1]],
                color="g", linewidth=1.5)
    if labels is not None:
        pos = refs[1][np.asarray(labels) == 1]
        ax.scatter(pos[:, 0], pos[:, 2], -pos[:, 1], s=40, marker="*", c="red",
                   label="positive sections")
    ax.set_xlabel("x")
    ax.set_ylabel("z (depth)")
    ax.set_zlabel("-y (up)")
    ax.legend(loc="upper right", fontsize=8)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def check_norm(points: np.ndarray, seg_labels: np.ndarray,
               box_corners: np.ndarray, save_path: str | None = None):
    """Normalized frustum with per-point fg/bg coloring."""
    plt = _require_mpl()
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    fg = np.asarray(seg_labels) > 0
    ax.scatter(points[~fg, 0], points[~fg, 2], -points[~fg, 1], s=1, c="gray", alpha=0.3)
    ax.scatter(points[fg, 0], points[fg, 2], -points[fg, 1], s=3, c="red")
    c = np.asarray(box_corners)
    for a, b in _BOX_EDGES:
        ax.plot([c[a, 0], c[b, 0]], [c[a, 2], c[b, 2]], [-c[a, 1], -c[b, 1]],
                color="g", linewidth=1.5)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def draw_projected_box3d(ax, corners_2d: np.ndarray, color="lime", linewidth=1.5):
    """Draw a projected 3D box (8x2 image-plane vertices) on an image axis.

    Equivalent of the reference's `kitti/draw_util.py:122-145` (cv2 lines ->
    matplotlib segments; same vertex-order convention as
    ``Calibration.rect_to_image`` over ``kitti_object_corners``).
    """
    for a, b in _BOX_EDGES:
        ax.plot([corners_2d[a, 0], corners_2d[b, 0]],
                [corners_2d[a, 1], corners_2d[b, 1]],
                color=color, linewidth=linewidth)


def compute_orientation_3d(obj, calib):
    """Heading-vector endpoints of an object, in rect 3D and image 2D.

    Equivalent of the reference's `kitti/kitti_util.py:362-389`: the segment
    from the box center to center + l along the heading direction, rotated by
    ry and translated to ``obj.t``. Returns ``(orientation_2d, orientation_3d)``
    with orientation_2d ``None`` when either endpoint sits behind the image
    plane (z < 0.1).
    """
    from frustum_convnet_tpu_torch.core.geometry_np import roty

    ends = np.array([[0.0, 0.0, 0.0], [obj.l, 0.0, 0.0]])  # (2, 3)
    ori3d = ends @ roty(obj.ry).T + np.asarray(obj.t)
    if np.any(ori3d[:, 2] < 0.1):
        return None, ori3d
    return calib.rect_to_image(ori3d), ori3d


def show_image_with_boxes(img: np.ndarray, objects, calib,
                          save_path: str | None = None):
    """2D + projected-3D GT boxes over an image.

    Equivalent of the reference's `kitti/draw_util.py:26-66` using
    matplotlib. ``objects`` are `data.kitti.calib.Object3d`; DontCare rows
    are skipped (they carry no 3D box).
    """
    from frustum_convnet_tpu_torch.data.kitti.prepare import kitti_object_corners

    plt = _require_mpl()
    fig, (ax2d, ax3d) = plt.subplots(1, 2, figsize=(16, 5))
    for ax in (ax2d, ax3d):
        ax.imshow(img)
        ax.set_axis_off()
    ax2d.set_title("2D boxes")
    ax3d.set_title("projected 3D boxes")
    for obj in objects:
        if obj.type == "DontCare":
            continue
        x1, y1, x2, y2 = obj.box2d
        ax2d.add_patch(plt.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                     fill=False, edgecolor="lime"))
        corners = kitti_object_corners(obj)
        if np.all(corners[:, 2] > 0.1):  # behind-camera boxes cannot project
            draw_projected_box3d(ax3d, calib.rect_to_image(corners))
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=110)
    return fig


def show_lidar_on_image(pc_velo: np.ndarray, img: np.ndarray, calib,
                        save_path: str | None = None):
    """LiDAR points projected onto the image, colored by depth.

    Equivalent of the reference's `kitti/draw_util.py:102-119` (cv2 circles
    -> matplotlib scatter with an hsv depth colormap).
    """
    from frustum_convnet_tpu_torch.data.kitti.prepare import lidar_in_image_fov_mask

    plt = _require_mpl()
    h, w = img.shape[:2]
    mask, pts_2d = lidar_in_image_fov_mask(pc_velo[:, :3], calib, h, w)
    uv = pts_2d[mask]
    depth = calib.velo_to_rect(pc_velo[mask, :3])[:, 2]
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.imshow(img)
    ax.scatter(uv[:, 0], uv[:, 1], c=np.clip(640.0 / depth, 0, 255),
               cmap="hsv", s=2, linewidths=0)
    ax.set_axis_off()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=110)
    return fig


def show_lidar_with_boxes(pc_velo: np.ndarray, objects, calib,
                          save_path: str | None = None):
    """3D scatter of the sweep with GT boxes (velo frame).

    Equivalent of the reference's `kitti/draw_util.py:69-99` (mayavi ->
    matplotlib 3D; boxes converted rect -> velo so everything shares the
    LiDAR frame).
    """
    from frustum_convnet_tpu_torch.data.kitti.prepare import kitti_object_corners

    plt = _require_mpl()
    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(projection="3d")
    sub = pc_velo[:: max(1, len(pc_velo) // 20000)]
    ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=0.3, c=sub[:, 0], cmap="viridis")
    for obj in objects:
        if obj.type == "DontCare":
            continue
        corners = kitti_object_corners(obj)
        draw_box3d(ax, calib.rect_to_velo(corners), color="r")
    ax.set_xlabel("x (fwd)")
    ax.set_ylabel("y (left)")
    ax.set_zlabel("z (up)")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=110)
    return fig
