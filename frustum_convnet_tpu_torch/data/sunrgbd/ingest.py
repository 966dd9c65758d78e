"""SUN-RGBD toolbox ``.mat`` metadata -> ``mysunrgbd/training`` layout.

Python replacement for the reference's one-time MATLAB dump
(reference `sunrgbd/matlab/extract_rgbd_data.m`): reads
``SUNRGBDtoolbox/Metadata/SUNRGBDMeta.mat`` with scipy.io and writes, per
1-based sample id,

* ``pc/%06d.npy``     — (N, 6) upright-depth points + rgb from the depth map
                        (MATLAB ``read3dPoints``; NaN rows dropped),
* ``image/%06d.jpg``  — copy of the rgb image,
* ``depth/%06d.png``  — copy of the raw 16-bit depth map,
* ``calib/%06d.txt``  — row 1 ``Rtilt(:)'``, row 2 ``K(:)'`` (column-major),
* ``label/%06d.txt``  — ``classname x y w h cx cy cz c1 c2 c3 b11 b12 b21
                        b22 ox oy`` per 3D box that has a 2D box
                        (``extract_rgbd_data.m:78-100``: box2d as ints,
                        coeffs = abs(original order), basis via order_basis),

plus the official train/val id lists (``allsplit.mat`` convention: val =
1..5050, train = 5051..10335, ``extract_rgbd_data.m:36-46``).
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from frustum_convnet_tpu_torch.data.sunrgbd.calib import SunCalibration, read_3d_points

META_PATH_PREFIX = "/n/fs/sun3d/data/SUNRGBD"


def order_basis(basis: np.ndarray, coeffs: np.ndarray,
                centroid: np.ndarray):
    """Canonicalize a 3x3 box basis (ref sunrgbd/matlab/order_basis.m).

    Rows are sorted so row 0 has the largest |x| component, then rows 1-2
    so row 1 has the larger |y| component; finally each row is flipped to
    point away from the viewer (negated when its projection onto the
    centroid direction is positive).
    """
    basis = np.asarray(basis, dtype=np.float64).copy()
    coeffs = np.asarray(coeffs, dtype=np.float64).ravel().copy()
    centroid = np.asarray(centroid, dtype=np.float64).ravel()

    inds = np.argsort(-np.abs(basis[:, 0]), kind="stable")
    basis, coeffs = basis[inds], coeffs[inds]
    if np.abs(basis[2, 1]) > np.abs(basis[1, 1]):
        basis[1:3] = basis[[2, 1]]
        coeffs[1:3] = coeffs[[2, 1]]

    direction = centroid / max(np.linalg.norm(centroid), 1e-12)
    flip = basis @ direction > 0
    basis[flip] *= -1.0
    return basis, coeffs


def _field(struct, name, default=None):
    """Read a field from a loadmat struct (mat_struct or record row)."""
    if hasattr(struct, name):
        return getattr(struct, name)
    try:
        return struct[name]
    except (KeyError, IndexError, ValueError, TypeError):
        return default


def _as_str(v) -> str:
    if isinstance(v, np.ndarray):
        v = "".join(str(c) for c in v.ravel()) if v.dtype.kind in "US" else str(v)
    return str(v)


def _struct_list(v):
    """Normalize a possibly-squeezed struct array field to a python list."""
    if v is None:
        return []
    arr = np.atleast_1d(np.asarray(v, dtype=object)).ravel()
    return [s for s in arr if s is not None]


def _remap_path(meta_path: str, sunrgbd_root: str) -> str:
    """``/n/fs/sun3d/data/SUNRGBD/kv1/...`` -> ``<root>/kv1/...``
    (extract_rgbd_data.m:55-58 strips the 25-char toolbox prefix)."""
    p = _as_str(meta_path)
    marker = "/SUNRGBD/"
    if p.startswith(META_PATH_PREFIX):
        rel = p[len(META_PATH_PREFIX):].lstrip("/")
    elif marker in p:
        rel = p.split(marker, 1)[1]
    else:
        rel = p.lstrip("/")
    return os.path.join(sunrgbd_root, rel)


def load_meta(meta_path: str):
    """Load SUNRGBDMeta.mat as a list of per-sample structs."""
    import scipy.io as sio

    mat = sio.loadmat(meta_path, struct_as_record=False, squeeze_me=True,
                      verify_compressed_data_integrity=False)
    key = next(k for k in ("SUNRGBDMeta", "SUNRGBDMeta2DBB") if k in mat)
    return _struct_list(mat[key])


def format_label_line(classname: str, box2d, centroid, coeffs, basis,
                      orientation) -> str:
    """One label line, bit-matching extract_rgbd_data.m:93-99: box2d printed
    with %d, coeffs are abs() in ORIGINAL order (the MATLAB script passes
    coeffs to order_basis by value and prints the un-reordered copy), basis
    is the order_basis output's top-left 2x2."""
    coeffs = np.abs(np.asarray(coeffs, dtype=np.float64).ravel())
    new_basis, _ = order_basis(basis, coeffs, centroid)
    b = np.asarray(box2d, dtype=np.float64).ravel()
    c = np.asarray(centroid, dtype=np.float64).ravel()
    o = np.asarray(orientation, dtype=np.float64).ravel()
    return (f"{classname} {int(b[0])} {int(b[1])} {int(b[2])} {int(b[3])} "
            f"{c[0]:f} {c[1]:f} {c[2]:f} "
            f"{coeffs[0]:f} {coeffs[1]:f} {coeffs[2]:f} "
            f"{new_basis[0, 0]:f} {new_basis[0, 1]:f} "
            f"{new_basis[1, 0]:f} {new_basis[1, 1]:f} "
            f"{o[0]:f} {o[1]:f}")


def ingest_sample(data, image_id: int, sunrgbd_root: str, save_root: str):
    """Dump one toolbox metadata entry into the mysunrgbd layout."""
    name = f"{image_id:06d}"
    rtilt = np.asarray(_field(data, "Rtilt"), dtype=np.float64)
    K = np.asarray(_field(data, "K"), dtype=np.float64)
    rgb_path = _remap_path(_field(data, "rgbpath"), sunrgbd_root)
    depth_path = _remap_path(_field(data, "depthpath"), sunrgbd_root)

    pts = read_3d_points(rgb_path, depth_path, rtilt, K)
    pts = pts[~np.isnan(pts[:, 0])]
    np.save(os.path.join(save_root, "pc", f"{name}.npy"),
            pts.astype(np.float32))

    shutil.copyfile(rgb_path, os.path.join(save_root, "image", f"{name}.jpg"))
    shutil.copyfile(depth_path, os.path.join(save_root, "depth", f"{name}.png"))

    with open(os.path.join(save_root, "calib", f"{name}.txt"), "w") as f:
        f.write(SunCalibration(Rtilt=rtilt, K=K).calib_text())

    boxes3d = _struct_list(_field(data, "groundtruth3DBB"))
    boxes2d = _struct_list(_field(data, "groundtruth2DBB"))
    lines = []
    for j, bb in enumerate(boxes3d):
        box2d = _field(boxes2d[j], "gtBb2D") if j < len(boxes2d) else None
        if box2d is None or np.asarray(box2d).size == 0:
            continue
        lines.append(format_label_line(
            _as_str(_field(bb, "classname")), box2d, _field(bb, "centroid"),
            _field(bb, "coeffs"), _field(bb, "basis"),
            _field(bb, "orientation")))
    with open(os.path.join(save_root, "label", f"{name}.txt"), "w") as f:
        f.write("".join(line + "\n" for line in lines))
    return len(lines)


def write_image_sets(set_root: str, n_samples: int,
                     val_end: int = 5050) -> None:
    """Official allsplit convention: val = 1..5050, train = rest."""
    os.makedirs(set_root, exist_ok=True)
    val_end = min(val_end, n_samples)
    with open(os.path.join(set_root, "val.txt"), "w") as f:
        f.writelines(f"{i:06d}\n" for i in range(1, val_end + 1))
    with open(os.path.join(set_root, "train.txt"), "w") as f:
        f.writelines(f"{i:06d}\n" for i in range(val_end + 1, n_samples + 1))


def ingest_sunrgbd(meta, sunrgbd_root: str, save_root: str,
                   set_root: str | None = None, ids=None) -> int:
    """``meta``: path to SUNRGBDMeta.mat, or an already-loaded meta list."""
    if isinstance(meta, str):
        meta = load_meta(meta)
    for sub in ("pc", "depth", "image", "calib", "label"):
        os.makedirs(os.path.join(save_root, sub), exist_ok=True)
    ids = list(ids) if ids is not None else range(1, len(meta) + 1)
    total = 0
    for image_id in ids:
        total += ingest_sample(meta[image_id - 1], image_id, sunrgbd_root,
                               save_root)
    if set_root:
        write_image_sets(set_root, len(meta))
    return total


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Dump SUNRGBD toolbox .mat metadata to mysunrgbd layout")
    p.add_argument("--meta", required=True,
                   help="path to SUNRGBDtoolbox/Metadata/SUNRGBDMeta.mat")
    p.add_argument("--sunrgbd_root", required=True,
                   help="SUNRGBD image root (contains kv1/kv2/realsense/xtion)")
    p.add_argument("--save_root", required=True,
                   help="output dir, e.g. data/mysunrgbd/training")
    p.add_argument("--image_sets", default=None,
                   help="also write train/val id lists into this dir")
    p.add_argument("--start", type=int, default=1)
    p.add_argument("--end", type=int, default=0,
                   help="last 1-based id (default: all)")
    args = p.parse_args(argv)

    meta = load_meta(args.meta)
    end = args.end or len(meta)
    n = ingest_sunrgbd(meta, args.sunrgbd_root, args.save_root,
                       set_root=args.image_sets,
                       ids=range(args.start, end + 1))
    print(f"ingested samples {args.start}..{end}: {n} labeled boxes")


if __name__ == "__main__":
    main()
