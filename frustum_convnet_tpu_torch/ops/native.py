"""ctypes bindings for the native boxgeom library, with numpy fallback.

The C++ library (``native/boxgeom/boxgeom.cc``) provides the host-side
rotated-IoU and NMS kernels the reference implemented with pybind11 + boost
(reference `ops/pybind11/`). pybind11 is not available in the target
image, so the binding is a thin ctypes layer; if the shared library has not
been built (``make -C native``), every entry point transparently falls back
to the pure-numpy implementations in :mod:`frustum_convnet_tpu_torch.core`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "build", "libboxgeom.so")
_EVAL_BIN = os.path.join(_REPO_ROOT, "native", "build", "kitti_eval_tpu")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def build_native(force: bool = False) -> bool:
    """Compile the native components; returns True on success."""
    if os.path.exists(_LIB_PATH) and os.path.exists(_EVAL_BIN) and not force:
        return True
    try:
        subprocess.run(["make", "-C", os.path.join(_REPO_ROOT, "native")],
                       check=True, capture_output=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not os.path.exists(_LIB_PATH):
        build_native()
    if os.path.exists(_LIB_PATH):
        lib = ctypes.CDLL(_LIB_PATH)
        c_d = ctypes.POINTER(ctypes.c_double)
        c_i64 = ctypes.POINTER(ctypes.c_int64)
        lib.rbbox_iou_3d_pair.argtypes = [c_d, c_d, ctypes.c_int64, c_d]
        lib.rbbox_iou_3d_matrix.argtypes = [c_d, c_d, ctypes.c_int64, ctypes.c_int64, c_d]
        lib.rbbox_iou_bev_matrix.argtypes = [c_d, c_d, ctypes.c_int64, ctypes.c_int64, c_d]
        lib.rotate_nms_3d.argtypes = [c_d, ctypes.c_int64, ctypes.c_double,
                                      ctypes.c_int64, c_i64]
        lib.rotate_nms_3d.restype = ctypes.c_int64
        lib.rotate_nms_bev.argtypes = [c_d, ctypes.c_int64, ctypes.c_double,
                                       ctypes.c_int64, c_i64]
        lib.rotate_nms_bev.restype = ctypes.c_int64
        lib.nms_axis_aligned.argtypes = [c_d, c_d, ctypes.c_int64,
                                         ctypes.c_double, ctypes.c_int64, c_i64]
        lib.nms_axis_aligned.restype = ctypes.c_int64
        _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _cptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def rbbox_iou_3d_pair(corners1: np.ndarray, corners2: np.ndarray) -> np.ndarray:
    """Paired (BEV, 3D) IoU, (n, 8, 3) x2 -> (n, 2)."""
    lib = _load()
    c1 = np.ascontiguousarray(corners1, dtype=np.float64)
    c2 = np.ascontiguousarray(corners2, dtype=np.float64)
    n = len(c1)
    if lib is None:
        from frustum_convnet_tpu_torch.core.iou_np import rotated_iou_3d_np
        return np.array([rotated_iou_3d_np(c1[i], c2[i]) for i in range(n)])
    out = np.empty((n, 2), dtype=np.float64)
    lib.rbbox_iou_3d_pair(_cptr(c1), _cptr(c2), n, _cptr(out))
    return out


def rbbox_iou_3d_matrix(corners1: np.ndarray, corners2: np.ndarray) -> np.ndarray:
    lib = _load()
    c1 = np.ascontiguousarray(corners1, dtype=np.float64)
    c2 = np.ascontiguousarray(corners2, dtype=np.float64)
    n, k = len(c1), len(c2)
    if lib is None:
        from frustum_convnet_tpu_torch.core.iou_np import rotated_iou_3d_np
        return np.array([[rotated_iou_3d_np(a, b)[1] for b in c2] for a in c1])
    out = np.empty((n, k), dtype=np.float64)
    lib.rbbox_iou_3d_matrix(_cptr(c1), _cptr(c2), n, k, _cptr(out))
    return out


def rotate_nms_3d(dets: np.ndarray, thresh: float, top_k: int = 300) -> list[int]:
    """dets (n, 8) = (cx, cy, cz, l, w, h, ry, score) -> kept indices."""
    lib = _load()
    d = np.ascontiguousarray(dets, dtype=np.float64)
    if lib is None:
        from frustum_convnet_tpu_torch.core.nms import rotate_nms_3d as np_nms
        return np_nms(d, thresh, top_k)
    keep = np.empty(len(d), dtype=np.int64)
    n = lib.rotate_nms_3d(_cptr(d), len(d), thresh, top_k,
                          keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return keep[:n].tolist()


def rotate_nms_bev(dets: np.ndarray, thresh: float, top_k: int = 300) -> list[int]:
    lib = _load()
    d = np.ascontiguousarray(dets, dtype=np.float64)
    if lib is None:
        from frustum_convnet_tpu_torch.core.nms import rotate_nms_bev as np_nms
        return np_nms(d, thresh, top_k)
    keep = np.empty(len(d), dtype=np.int64)
    n = lib.rotate_nms_bev(_cptr(d), len(d), thresh, top_k,
                           keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return keep[:n].tolist()


def evaluate_kitti_native(gt_dir: str, result_dir: str,
                          protocol: str = "offline") -> Optional[str]:
    """Run the native evaluator binary; returns its stdout or None.

    ``protocol``: ``"offline"`` (devkit offline binary semantics) or
    ``"server"`` (KITTI submission-server variant) — see kitti_eval.cc.
    """
    if not os.path.exists(_EVAL_BIN):
        build_native()
    if not os.path.exists(_EVAL_BIN):
        return None
    proc = subprocess.run([_EVAL_BIN, gt_dir, result_dir,
                           "--protocol", protocol],
                          capture_output=True, text=True)
    return proc.stdout if proc.returncode == 0 else None
