"""Reference-compatible frustum pickle IO.

The reference stores offline-prepared frustums as *sequential pickle
streams* — N successive ``pickle.load`` calls on one file, one list per
field (reference `datasets/provider_sample.py:83-108`,
`kitti/prepare_data.py:378-389`). These helpers read/write the same
layouts so artifacts are interchangeable with the reference:

* labeled KITTI stage-1 (11 streams): id, box2d, box3d(8 corners), points,
  seg labels, type, heading, size, frustum_angle, gt_box2d, calib
* rgb-detection KITTI (7 streams): id, box2d, points, type, frustum_angle,
  detection prob, calib
* refine stage-2 labeled (13 streams): stage-1 fields + pred box corners /
  size / angle (`datasets/provider_sample_refine.py:101-117`)
* refine rgb-detection (9 streams)
* SUN-RGBD: a single pickled dict (`datasets/provider_sample_sunrgbd.py:79-111`)
"""

from __future__ import annotations

import pickle
from typing import Dict, List

KITTI_LABELED_FIELDS = [
    "id", "box2d", "box3d", "points", "seg", "type",
    "heading", "size", "frustum_angle", "gt_box2d", "calib",
]
KITTI_RGBDET_FIELDS = [
    "id", "box2d", "points", "type", "frustum_angle", "prob", "calib",
]
# refine stage stream orders follow `datasets/provider_sample_refine.py:101-117`
# (box2d after frustum_angle; pred box = the x1.2-enlarged stage-1 box)
REFINE_LABELED_FIELDS = [
    "id", "box3d", "points", "seg", "type", "heading", "size",
    "frustum_angle", "box2d", "calib",
    "pred_box3d", "pred_box3d_size", "pred_box3d_angle",
]
REFINE_RGBDET_FIELDS = [
    "id", "box2d", "points", "type", "frustum_angle", "prob", "calib",
    "pred_box3d", "pred_box3d_size", "pred_box3d_angle",
]


def write_stream_pickle(path: str, data: Dict[str, List], fields: List[str]) -> None:
    lengths = {k: len(data[k]) for k in fields}
    assert len(set(lengths.values())) == 1, f"ragged streams: {lengths}"
    with open(path, "wb") as f:
        for k in fields:
            pickle.dump(data[k], f, protocol=pickle.HIGHEST_PROTOCOL)


def read_stream_pickle(path: str, fields: List[str]) -> Dict[str, List]:
    out = {}
    with open(path, "rb") as f:
        for k in fields:
            out[k] = pickle.load(f)
    n = len(out[fields[0]])
    assert all(len(v) == n for v in out.values()), "ragged streams"
    return out


def write_dict_pickle(path: str, data: Dict) -> None:
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)


def read_dict_pickle(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)
