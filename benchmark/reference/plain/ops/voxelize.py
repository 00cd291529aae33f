"""Hard voxelization with static shapes (counterpart of robustpointclouds_tpu/ops/voxelize.py).

Points -> padded voxels [B, V, T, F] + coords + counts, in torch ops on the
points' device: the inline (plan=None) path voxelises on the card inside
the step, the plan-fed path gets the same arrays from the host plan
(data/native_plan.py), bit for bit.

Sort-based grouping, as in JAX: each point is keyed by its flat voxel id
(out-of-range and padding points by a sentinel that sorts last), the keys
are sorted stably, each run of equal keys is one voxel in ascending id
order, and the first `max_voxels` voxels and the first
`max_points_per_voxel` points of each survive. The batch is a leading
dimension (JAX vmaps one sample).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.device import device_constant
from . import sparse


class VoxelizerConfig(NamedTuple):
    point_cloud_range: Tuple[float, float, float, float, float, float]
    voxel_size: Tuple[float, float, float]
    max_points_per_voxel: int
    max_voxels: int

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) number of voxels per axis."""
        pcr = np.asarray(self.point_cloud_range, np.float64)
        vs = np.asarray(self.voxel_size, np.float64)
        g = np.round((pcr[3:] - pcr[:3]) / vs).astype(np.int64)
        return int(g[0]), int(g[1]), int(g[2])

    @property
    def sparse_shape(self) -> Tuple[int, int, int]:
        """(nz+1, ny, nx) — the middle-encoder grid (z padded by 1, the
        SECOND convention: [41, 1600, 1408] for KITTI)."""
        nx, ny, nz = self.grid_size
        return nz + 1, ny, nx


class VoxelizationResult(NamedTuple):
    voxels: torch.Tensor      # [B, V, T, F] padded point features per voxel
    coords: torch.Tensor      # [B, V, 3] (z, y, x) int32; -1 rows are padding
    num_points: torch.Tensor  # [B, V] int32; 0 marks padding voxels
    voxel_mask: torch.Tensor  # [B, V] bool
    point_mask: torch.Tensor  # [B, V, T] bool per-slot validity
    slot_point: Optional[torch.Tensor] = None  # [B, V, T] int32 point index; P = miss
    point_slot: Optional[torch.Tensor] = None  # [B, P] int32 flat slot v*T + t; V*T = dropped


def voxelize_batch(points: torch.Tensor, points_mask: torch.Tensor,
                   cfg: VoxelizerConfig) -> VoxelizationResult:
    """Voxelise a padded batch on the points' device.

    Args:
        points: [B, P, F] float32 with xyz in the first 3 features.
        points_mask: [B, P] bool, False for padding rows.
        cfg: static voxelizer config.
    """
    bsz, p, f = points.shape
    v, t = cfg.max_voxels, cfg.max_points_per_voxel
    nx, ny, nz = cfg.grid_size
    dev = points.device
    # the bin divides by a device tensor: torch turns a division by a host
    # scalar into a multiply by its reciprocal, which can round differently
    pcr = device_constant(cfg.point_cloud_range[:3], points.dtype, dev)
    vs = device_constant(cfg.voxel_size, points.dtype, dev)
    ijk = torch.floor((points[..., :3] - pcr) / vs).to(torch.int32)
    ix, iy, iz = ijk.unbind(-1)
    in_range = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0) & (iz < nz)
                & points_mask.bool())
    sentinel = nz * ny * nx
    flat = iz.long() * (ny * nx) + iy.long() * nx + ix.long()
    flat = torch.where(in_range, flat, torch.full_like(flat, sentinel)).to(torch.int32)

    flat_s, order = torch.sort(flat, dim=1, stable=True)
    valid_s = torch.gather(in_range, 1, order)
    pos = torch.arange(p, dtype=torch.int32, device=dev).expand(bsz, p)
    is_new = torch.ones_like(valid_s)
    is_new[:, 1:] = flat_s[:, 1:] != flat_s[:, :-1]
    is_new &= valid_s
    voxel_rank = torch.cumsum(is_new.to(torch.int32), dim=1, dtype=torch.int32) - 1
    # a point's slot within its voxel: its position minus the voxel's start
    start = torch.cummax(torch.where(is_new, pos, torch.zeros_like(pos)), dim=1).values
    slot = pos - start

    keep = valid_s & (voxel_rank >= 0) & (voxel_rank < v) & (slot < t)
    # kept points write slot (b, v, t) once each; dropped ones go to the
    # scratch row B*V*T, sliced away
    bcol = torch.arange(bsz, dtype=torch.int64, device=dev)[:, None]
    n_slots = bsz * v * t
    sv, st = voxel_rank.long(), slot.long()
    tgt = torch.where(keep, (bcol * v + sv) * t + st, torch.full_like(sv, n_slots))

    pts_s = torch.gather(points, 1, order[..., None].expand(bsz, p, f))
    zero = torch.zeros((), dtype=points.dtype, device=dev)
    voxels = sparse.scatter_set(n_slots, tgt, torch.where(keep[..., None], pts_s, zero),
                                0.0).reshape(bsz, v, t, f)
    point_mask = sparse.scatter_set(n_slots, tgt, keep, False).reshape(bsz, v, t)
    num_points = point_mask.sum(2, dtype=torch.int32)

    # coords (z, y, x) from each voxel's flat id, written by its first point
    first = keep & is_new
    flat_of_voxel = sparse.scatter_set(
        bsz * v, torch.where(first, bcol * v + sv, torch.full_like(sv, bsz * v)),
        torch.where(first, flat_s, torch.full_like(flat_s, sentinel)), sentinel).reshape(bsz, v)
    voxel_mask = num_points > 0
    cz = torch.div(flat_of_voxel, ny * nx, rounding_mode="floor")
    rem = flat_of_voxel - cz * (ny * nx)
    cy = torch.div(rem, nx, rounding_mode="floor")
    cx = rem - cy * nx
    coords = torch.where(voxel_mask[..., None], torch.stack([cz, cy, cx], -1),
                         torch.full((), -1, dtype=torch.int32, device=dev))

    # the point <-> slot maps (order[b, s] = original index of sorted row s)
    order32 = order.to(torch.int32)
    slot_point = sparse.scatter_set(n_slots, tgt, torch.where(keep, order32,
                                                              torch.full_like(order32, p)),
                                    p).reshape(bsz, v, t)
    flat_slot = torch.where(keep, (sv * t + st).to(torch.int32), torch.full_like(order32, v * t))
    # order is a permutation of each sample's points: every target once
    point_slot = sparse.scatter_set(bsz * p, bcol * p + order, flat_slot, v * t).reshape(bsz, p)
    return VoxelizationResult(voxels, coords, num_points, voxel_mask, point_mask,
                              slot_point, point_slot)
