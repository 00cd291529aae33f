"""HardSimpleVFE: per-voxel masked mean of point features (counterpart of robustpointclouds_tpu/nn/vfe.py)."""
from __future__ import annotations

import torch


def HardSimpleVFE(voxels: torch.Tensor, point_mask: torch.Tensor) -> torch.Tensor:
    """voxels [..., V, T, F], point_mask [..., V, T] -> [..., V, F] (0 for empty voxels)."""
    m = point_mask.to(voxels.dtype)[..., None]
    total = (voxels * m).sum(-2)
    count = torch.clamp(m.sum(-2), min=1.0)
    return total / count
