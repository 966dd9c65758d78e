"""KITTI detection-result writer, bit-compatible with the reference output.

Produces ``<result_dir>/data/%06d.txt`` label files in exactly the format of
reference `train/test_net_det.py:88-152`: per-line
``<cls> -1 -1 <alpha> x1 y1 x2 y2 h w l tx ty tz ry score`` with %.4f fields
(score %f), alpha recomputed from (tx, tz, ry), optional pre-write 3D
rotated NMS, and empty files filled for every id in the split so the C++
evaluator sees a complete result set.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Iterable, List

import numpy as np

from frustum_convnet_tpu_torch.core.geometry_np import compute_alpha
# native C++ NMS when built (make -C native), numpy fallback otherwise
from frustum_convnet_tpu_torch.ops.native import rotate_nms_3d

# det entry layout (matches the test driver accumulation):
# [x1, y1, x2, y2, tx, ty, tz, h, w, l, ry, score]
DetResults = Dict[int, Dict[str, List[List[float]]]]


def apply_cube_nms(det_results: DetResults, threshold: float) -> DetResults:
    """Per-image per-class 3D rotated NMS (ref write_detection_results_nms)."""
    out: DetResults = {}
    for idx, per_class in det_results.items():
        out[idx] = {}
        for cls, dets in per_class.items():
            arr = np.asarray(dets, dtype=np.float32)
            if len(arr) > 1:
                # (tx,ty,tz,h,w,l,ry,score) -> (tx,ty,tz,l,w,h,ry,score)
                dets_nms = arr[:, 4:][:, [0, 1, 2, 5, 4, 3, 6, 7]]
                keep = rotate_nms_3d(dets_nms, threshold)
                arr = arr[keep]
            out[idx][cls] = arr.tolist()
    return out


def write_detection_results(result_dir: str, det_results: DetResults,
                            split_ids: Iterable[int] = (),
                            nms_threshold: float | None = None) -> str:
    """Write result label files; returns the ``data`` directory path."""
    if nms_threshold is not None:
        det_results = apply_cube_nms(det_results, nms_threshold)

    data_dir = os.path.join(result_dir, "data")
    shutil.rmtree(data_dir, ignore_errors=True)
    os.makedirs(data_dir)

    lines_by_idx: Dict[int, List[str]] = {}
    for idx, per_class in det_results.items():
        for cls, dets in per_class.items():
            for det in dets:
                x1, y1, x2, y2 = det[:4]
                tx, ty, tz, h, w, l, ry = det[4:-1]
                score = det[-1]
                alpha = compute_alpha(tx, tz, ry)
                line = (
                    f"{cls} -1 -1 {alpha:.4f} "
                    f"{x1:.4f} {y1:.4f} {x2:.4f} {y2:.4f} "
                    f"{h:.4f} {w:.4f} {l:.4f} {tx:.4f} {ty:.4f} {tz:.4f} {ry:.4f} {score:f}"
                )
                lines_by_idx.setdefault(idx, []).append(line)

    for idx, lines in lines_by_idx.items():
        with open(os.path.join(data_dir, f"{idx:06d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    # every split frame needs a (possibly empty) file (ref fill_files)
    for idx in split_ids:
        path = os.path.join(data_dir, f"{int(idx):06d}.txt")
        if not os.path.exists(path):
            open(path, "w").close()
    return data_dir
