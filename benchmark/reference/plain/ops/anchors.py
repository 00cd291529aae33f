"""3D anchor generation over BEV feature grids (a copy of robustpointclouds_tpu/ops/anchors.py).

Equivalent of `Anchor3DRangeGenerator` (reference config
configs/adversarial/adversarial-second_hv_secfpn_8xb6-80e_kitti-3d-3class.py:44-53):
per-class anchor ranges + sizes + rotations, placed on an edge-aligned linspace
over the feature map. Anchors are precomputed once (static shapes) and closed
over by the jitted loss/predict functions.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def generate_anchors(
    feature_size: Tuple[int, int],
    ranges: Sequence[Sequence[float]],
    sizes: Sequence[Sequence[float]],
    rotations: Sequence[float] = (0.0, 1.5707963),
) -> np.ndarray:
    """Generate anchors for every (class, rotation) at every BEV location.

    Args:
        feature_size: (ny, nx) BEV feature map size, e.g. (200, 176).
        ranges: per-class [x_min, y_min, z, x_max, y_max, z] anchor ranges
            (z duplicated: single z plane per class). Following the mmdet3d
            convention the range z is the anchor BOTTOM: mmdet3d's
            `DeltaXYZWLHRBBoxCoder.encode` shifts both anchor and GT by
            +h/2 before taking deltas, so the anchor's *effective* gravity
            center is `z + dz/2`. This framework stores gravity-center z
            everywhere (see data/kitti.py label conversion), so the shift is
            applied here, once, at generation time — decoded boxes from
            converted mmdet3d zoo checkpoints land at the correct height.
        sizes: per-class [dx, dy, dz] anchor sizes.
        rotations: anchor yaw angles.

    Returns:
        anchors [ny, nx, num_classes, num_rot, 7] float32. Flattening the
        middle dims with `.reshape(ny, nx, -1, 7)` matches the head's channel
        layout (class-major, rotation-minor).
    """
    assert len(ranges) == len(sizes), "one range per class size"
    ny, nx = feature_size
    num_cls = len(sizes)
    num_rot = len(rotations)
    out = np.zeros((ny, nx, num_cls, num_rot, 7), dtype=np.float32)
    for ci, (rng, size) in enumerate(zip(ranges, sizes)):
        x_min, y_min, z_lo, x_max, y_max, z_hi = rng
        # Edge-aligned centers (matches mmdet3d Anchor3DRangeGenerator's
        # torch.linspace(range_min, range_max, n) placement).
        x_centers = np.linspace(x_min, x_max, nx, dtype=np.float32)
        y_centers = np.linspace(y_min, y_max, ny, dtype=np.float32)
        # range z is the box bottom (mmdet3d convention) -> gravity center
        z_center = np.float32((z_lo + z_hi) * 0.5 + size[2] * 0.5)
        for ri, rot in enumerate(rotations):
            out[:, :, ci, ri, 0] = x_centers[None, :]
            out[:, :, ci, ri, 1] = y_centers[:, None]
            out[:, :, ci, ri, 2] = z_center
            out[:, :, ci, ri, 3:6] = np.asarray(size, dtype=np.float32)
            out[:, :, ci, ri, 6] = rot
    return out


def flatten_anchors(anchors: np.ndarray) -> np.ndarray:
    """[ny, nx, C, R, 7] -> [ny*nx*C*R, 7] in the head's prediction order."""
    return anchors.reshape(-1, 7)


def anchor_class_ids(feature_size: Tuple[int, int], num_classes: int, num_rot: int) -> np.ndarray:
    """Class id of each flattened anchor, aligned with :func:`flatten_anchors`."""
    ny, nx = feature_size
    ids = np.tile(
        np.repeat(np.arange(num_classes, dtype=np.int32), num_rot), ny * nx
    )
    return ids
