"""ctypes binding of the native point-cloud pipeline (the port's csrc/pointcloud.cpp; counterpart of robustpointclouds_tpu/data/native.py).

The port's own copy of the C++ source that the JAX package binds (byte for
byte the same, so the same seed gives the same batches bit for bit). It
compiles with g++ on first use into `build/torch_pointcloud/`, apart from
the JAX package's build. No compiler means an error: `prepare_batch` never
falls back to numpy (data/kitti.kitti_epoch_loader takes the numpy path
only when asked with `use_native=False`).

Bound: `load_points` (the .bin reader), `prepare_batch` (threaded IO +
global flip / rotation / scale + range filter + shuffle and pad) and
`load_sweeps` (the NuScenes multi-sweep reader: threaded IO of 5-float
sweeps, each brought into the key frame and stamped with its time lag).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "pointcloud.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_pointcloud")
_SO = os.path.join(_BUILD_DIR, "libpointcloud.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# the KITTI layout (x, y, z, intensity) and the reference's global
# augmentation: rotation in +-pi/4, scale in [0.95, 1.05], a y-flip half the time
STRIDE = 4
ROT_RANGE = 0.78539816
SCALE_RANGE = (0.95, 1.05)
SCRATCH_POINTS = 200000  # points a frame may hold before range filtering

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int)


def get_lib() -> ctypes.CDLL:
    """The pipeline library, compiled with g++ on first use (or when the source is newer)."""
    global _lib
    with _lock:
        if _lib is None:
            if not os.path.isfile(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = f"{_SO}.{os.getpid()}.tmp"
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", _SRC,
                                "-o", tmp], check=True, capture_output=True)
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(_SO)
            lib.rpc_load_points.restype = ctypes.c_int
            lib.rpc_load_points.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int, ctypes.c_int]
            lib.rpc_prepare_batch.restype = None
            lib.rpc_prepare_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, _F32P,
                ctypes.c_uint, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                _F32P, _I32P, ctypes.c_int, _U8P, _F32P, _U8P, ctypes.c_int, _I32P,
                ctypes.c_int]
            lib.rpc_load_sweeps.restype = None
            lib.rpc_load_sweeps.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, _F32P, _U8P, _F32P,
                ctypes.c_int, _F32P, ctypes.c_int, _I32P]
            _lib = lib
        return _lib


def load_points(path: str, max_points: int = SCRATCH_POINTS) -> np.ndarray:
    """Native velodyne .bin reader: [n, 4] float32, at most max_points rows."""
    lib = get_lib()
    out = np.empty((max_points, STRIDE), np.float32)
    n = lib.rpc_load_points(path.encode(), out.ctypes.data_as(_F32P), max_points, STRIDE)
    if n < 0:
        raise IOError(f"cannot read {path}")
    return out[:n]


def prepare_batch(paths: Sequence[str], boxes: np.ndarray, n_boxes: np.ndarray,
                  pcr: Sequence[float], max_points: int, seed: int, augment: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Threaded native batch preparation, one thread a frame: read the .bin,
    (augment: one global rotation, scale and y-flip drawn from the frame's
    seed, applied to its points and boxes), range-filter, shuffle and pad.

    `boxes` [B, G, 7] float32 is augmented in place when it is already a
    C-contiguous float32 array (the JAX binding's behaviour, which
    kitti_epoch_loader relies on); `n_boxes` [B] counts each row's real boxes.
    Returns (points [B, max_points, 4], mask [B, max_points], box_keep
    [B, G] (centre inside the BEV range), counts [B])."""
    lib = get_lib()
    B = len(paths)
    G = boxes.shape[1]
    boxes = np.ascontiguousarray(boxes, np.float32)
    out_points = np.zeros((B, max_points, STRIDE), np.float32)
    out_mask = np.zeros((B, max_points), np.uint8)
    box_keep = np.zeros((B, G), np.uint8)
    counts = np.zeros(B, np.int32)
    pcr_arr = np.asarray(pcr, np.float32)
    n_boxes = np.ascontiguousarray(n_boxes, np.int32)
    if n_boxes.shape != (B,) or boxes.shape[0] != B or (n_boxes > G).any():
        raise ValueError(f"boxes {boxes.shape} / n_boxes {n_boxes.shape} do not match {B} paths")
    path_arr = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    lib.rpc_prepare_batch(
        path_arr, B, STRIDE, pcr_arr.ctypes.data_as(_F32P), ctypes.c_uint(seed & 0xFFFFFFFF),
        int(augment), ROT_RANGE, SCALE_RANGE[0], SCALE_RANGE[1], boxes.ctypes.data_as(_F32P),
        n_boxes.ctypes.data_as(_I32P), G, box_keep.ctypes.data_as(_U8P),
        out_points.ctypes.data_as(_F32P), out_mask.ctypes.data_as(_U8P), max_points,
        counts.ctypes.data_as(_I32P), SCRATCH_POINTS)
    bad = [p for p, c in zip(paths, counts) if c < 0]
    if bad:
        raise IOError(f"cannot read {bad}")
    return out_points, out_mask.astype(bool), box_keep.astype(bool), counts


def load_sweeps(paths: Sequence[str], rts: Sequence[Optional[np.ndarray]], lags: Sequence[float],
                max_points: int = 40000, stride: int = 5, ts_ch: int = 4) -> list:
    """Threaded native multi-sweep load (NuScenes LoadPointsFromMultiSweeps):
    one thread a sweep reads its [n, stride] float32 points (at most
    max_points), applies xyz' = R xyz + T (rts[s]: [3, 4] row-major [R|T],
    or None for the identity) and sets channel ts_ch to lags[s]. Returns
    the sweeps' arrays, those that cannot be read dropped."""
    lib = get_lib()
    n = len(paths)
    out = np.zeros((n, max_points, stride), np.float32)
    counts = np.zeros(n, np.int32)
    rt_arr = np.zeros((n, 12), np.float32)
    rt_valid = np.zeros(n, np.uint8)
    for i, rt in enumerate(rts):
        if rt is not None:
            rt_arr[i] = np.asarray(rt, np.float32).reshape(12)
            rt_valid[i] = 1
    lag_arr = np.ascontiguousarray(lags, np.float32)
    path_arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.rpc_load_sweeps(path_arr, n, stride, rt_arr.ctypes.data_as(_F32P),
                        rt_valid.ctypes.data_as(_U8P), lag_arr.ctypes.data_as(_F32P), ts_ch,
                        out.ctypes.data_as(_F32P), max_points, counts.ctypes.data_as(_I32P))
    return [out[i, :counts[i]] for i in range(n) if counts[i] >= 0]
