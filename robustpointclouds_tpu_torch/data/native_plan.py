"""ctypes binding of the native sparse-plan builder (the port's csrc/plan.cpp).

The port's own copy of the C++ builder that the JAX package binds in
robustpointclouds_tpu/data/native_plan.py (the copy is byte for byte the
same source, so the plans are bit-equal). It compiles into
`build/torch_plan/libplan.so`, apart from the JAX package's build, so the
two packages never race on one library, and returns the same dict of numpy
arrays: voxels, masks, the batch-merge order, the merged grid and the
encoder's index plan under "enc". The layout differs by level:
  * rel0, rel1, down1, down2: x-window `rows`/`xvalid`;
  * rel2, rel3, down3: dense `[M, 27]` `idx`;
  * out: `[n4, 3]` `idx` (the (3,1,1) conv_out taps);
  * every downN and out also carry the inverse index `inv`.
The pillar family's plan (`build_pillar_plan_native`, `rpc_build_pillar_plan`)
holds the voxels, the merged (batch, y, x) BEV grid and its dense-cell map
"dense" instead of an encoder plan. No compiler means an error, not a
fallback.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "plan.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_plan")
_SO = os.path.join(_BUILD_DIR, "libplan.so")

# default SparseEncoder layout constants the C++ traversal is fixed to
_STAGE_FACTORS = (1.0, 1.0, 0.75, 0.5)
_OUT_FACTOR = 0.5


def level_caps(n: int) -> Tuple[int, int, int, int]:
    """Row caps of down1, down2, down3 and conv_out's grid over `n` = B *
    max_voxels merged rows (the torch builder of nn/sparse_encoder.py reads
    them too, so the two plans truncate alike)."""
    return tuple(max(int(n * f), 1) for f in _STAGE_FACTORS[1:] + (_OUT_FACTOR,))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The builder library, compiled with g++ on first use (or when the source is newer)."""
    global _lib
    with _lock:
        if _lib is None:
            if not os.path.isfile(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = f"{_SO}.{os.getpid()}.tmp"
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(_SO)
            lib.rpc_build_plan.restype = ctypes.c_int
            lib.rpc_build_pillar_plan.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_pillar_plan_native(points: np.ndarray, points_mask: np.ndarray, voxelizer,
                             num_features: int = 4) -> dict:
    """The pillar family's host plan, as a dict of numpy arrays: voxels and
    their masks, the merged 2D grid (`grid_coords` (b, y, x)) with the
    order that aligns the voxels to it, and `dense`, the grid row of each
    of the B * ny * nx BEV cells (B * V for an empty one).

    Needs a single-z pillar grid (nz == 1): each sample's voxels then come
    in ascending 2D flat order, which the batch merge relies on."""
    lib = get_lib()
    nx, ny, nz = voxelizer.grid_size
    assert nz == 1, "the native pillar plan needs a single-z pillar grid"
    B, P = points.shape[:2]
    F = num_features
    if B * ny * nx >= 2 ** 31:
        raise ValueError(f"merged BEV id space of B={B} over {ny} x {nx} exceeds int32")
    V, T = voxelizer.max_voxels, voxelizer.max_points_per_voxel
    N = B * V
    pts = np.ascontiguousarray(points[..., :F], np.float32)
    msk = np.ascontiguousarray(points_mask, np.uint8)
    pcr = np.asarray(voxelizer.point_cloud_range, np.float32)
    vs = np.asarray(voxelizer.voxel_size, np.float32)
    # output buffers, in the order rpc_build_pillar_plan writes them
    a = {
        "voxels": np.empty((B, V, T, F), np.float32),
        "vox_coords": np.empty((B, V, 3), np.int32),
        "num_points": np.empty((B, V), np.int32),
        "voxel_mask": np.empty((B, V), bool),
        "point_mask": np.empty((B, V, T), bool),
        "order": np.empty((N,), np.int32),
        "grid_ids": np.empty((N,), np.int32),
        "grid_coords": np.empty((N, 3), np.int32),
        "grid_mask": np.empty((N,), bool),
        "dense": np.empty((B * ny * nx,), np.int32),
        "slot_point": np.empty((B, V, T), np.int32),
        "point_slot": np.empty((B, P), np.int32),
    }
    outs = (ctypes.c_void_p * len(a))(
        *[v.ctypes.data_as(ctypes.c_void_p).value for v in a.values()]
    )
    rc = lib.rpc_build_pillar_plan(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        msk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(B), ctypes.c_int64(P), ctypes.c_int64(F),
        pcr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(V), ctypes.c_int64(T),
        ctypes.c_int64(nx), ctypes.c_int64(ny), ctypes.c_int64(nz),
        outs,
    )
    if rc != 0:
        raise RuntimeError(f"rpc_build_pillar_plan failed: {rc}")
    return a


def build_plan_native(points: np.ndarray, points_mask: np.ndarray, voxelizer,
                      num_features: int) -> dict:
    """Voxelise + batch-merge + every encoder index, as a dict of numpy arrays.

    Args:
        points: [B, P, F>=num_features] float32.
        points_mask: [B, P] bool.
        voxelizer: ops/voxelize.VoxelizerConfig.
        num_features: features per point fed to the encoder (4 for KITTI).
    """
    lib = get_lib()
    B, P = points.shape[:2]
    F = num_features
    nx, ny, nz = voxelizer.grid_size
    if B * (nz + 1) * ny * nx >= 2 ** 31:
        raise ValueError(f"merged flat id space of B={B} over grid {voxelizer.grid_size} "
                         "exceeds int32")
    V, T = voxelizer.max_voxels, voxelizer.max_points_per_voxel
    N = B * V
    n1, n2, n3, n4 = level_caps(N)

    pts = np.ascontiguousarray(points[..., :F], np.float32)
    msk = np.ascontiguousarray(points_mask, np.uint8)
    pcr = np.asarray(voxelizer.point_cloud_range, np.float32)
    vs = np.asarray(voxelizer.voxel_size, np.float32)
    factors = np.asarray(
        [_STAGE_FACTORS[1], _STAGE_FACTORS[2], _STAGE_FACTORS[3], _OUT_FACTOR], np.float64
    )

    # output buffers, in the order rpc_build_plan writes them
    a = {
        "voxels": np.empty((B, V, T, F), np.float32),
        "vox_coords": np.empty((B, V, 3), np.int32),
        "num_points": np.empty((B, V), np.int32),
        "voxel_mask": np.empty((B, V), bool),
        "point_mask": np.empty((B, V, T), bool),
        "order": np.empty((N,), np.int32),
        "grid_ids": np.empty((N,), np.int32),
        "grid_coords": np.empty((N, 4), np.int32),
        "grid_mask": np.empty((N,), bool),
        "rel0_rows": np.empty((N, 9), np.int32),
        "rel0_xv": np.empty((N, 3), bool),
        "d1_ids": np.empty((n1,), np.int32),
        "d1_coords": np.empty((n1, 4), np.int32),
        "d1_mask": np.empty((n1,), bool),
        "d1_inv": np.empty((N, 27), np.int32),
        "d1_rows": np.empty((n1, 9), np.int32),
        "d1_xv": np.empty((n1, 3), bool),
        "rel1_rows": np.empty((n1, 9), np.int32),
        "rel1_xv": np.empty((n1, 3), bool),
        "d2_ids": np.empty((n2,), np.int32),
        "d2_coords": np.empty((n2, 4), np.int32),
        "d2_mask": np.empty((n2,), bool),
        "d2_inv": np.empty((n1, 27), np.int32),
        "d2_rows": np.empty((n2, 9), np.int32),
        "d2_xv": np.empty((n2, 3), bool),
        "rel2_idx": np.empty((n2, 27), np.int32),
        "d3_ids": np.empty((n3,), np.int32),
        "d3_coords": np.empty((n3, 4), np.int32),
        "d3_mask": np.empty((n3,), bool),
        "d3_inv": np.empty((n2, 27), np.int32),
        "d3_idx": np.empty((n3, 27), np.int32),
        "rel3_idx": np.empty((n3, 27), np.int32),
        "o_ids": np.empty((n4,), np.int32),
        "o_coords": np.empty((n4, 4), np.int32),
        "o_mask": np.empty((n4,), bool),
        "o_inv": np.empty((n3, 3), np.int32),
        "o_idx": np.empty((n4, 3), np.int32),
        "slot_point": np.empty((B, V, T), np.int32),
        "point_slot": np.empty((B, P), np.int32),
    }
    outs = (ctypes.c_void_p * len(a))(
        *[v.ctypes.data_as(ctypes.c_void_p).value for v in a.values()]
    )
    rc = lib.rpc_build_plan(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        msk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(B), ctypes.c_int64(P), ctypes.c_int64(F),
        pcr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(V), ctypes.c_int64(T),
        ctypes.c_int64(nx), ctypes.c_int64(ny), ctypes.c_int64(nz),
        factors.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        outs,
    )
    if rc != 0:
        raise RuntimeError(f"rpc_build_plan failed: {rc}")

    return {
        "voxels": a["voxels"],
        "vox_coords": a["vox_coords"],
        "num_points": a["num_points"],
        "voxel_mask": a["voxel_mask"],
        "point_mask": a["point_mask"],
        "slot_point": a["slot_point"],
        "point_slot": a["point_slot"],
        "order": a["order"],
        "grid_ids": a["grid_ids"],
        "grid_coords": a["grid_coords"],
        "grid_mask": a["grid_mask"],
        "enc": {
            "rel0": {"rows": a["rel0_rows"], "xvalid": a["rel0_xv"]},
            "down1": {"ids": a["d1_ids"], "coords": a["d1_coords"],
                      "mask": a["d1_mask"], "inv": a["d1_inv"],
                      "rows": a["d1_rows"], "xvalid": a["d1_xv"]},
            "rel1": {"rows": a["rel1_rows"], "xvalid": a["rel1_xv"]},
            "down2": {"ids": a["d2_ids"], "coords": a["d2_coords"],
                      "mask": a["d2_mask"], "inv": a["d2_inv"],
                      "rows": a["d2_rows"], "xvalid": a["d2_xv"]},
            "rel2": {"idx": a["rel2_idx"]},
            "down3": {"ids": a["d3_ids"], "coords": a["d3_coords"],
                      "mask": a["d3_mask"], "inv": a["d3_inv"],
                      "idx": a["d3_idx"]},
            "rel3": {"idx": a["rel3_idx"]},
            "out": {"ids": a["o_ids"], "coords": a["o_coords"],
                    "mask": a["o_mask"], "inv": a["o_inv"],
                    "idx": a["o_idx"]},
        },
    }
