"""Mask-aware statistics and batch norm (counterpart of robustpointclouds_tpu/nn/layers.py).

Sparse voxel tensors are padded to static shapes, so every normalisation
ignores padding rows through a mask. The masked statistics and the whole
MaskedBatchNorm (statistics, normalisation, affine, and optionally ReLU and
the row mask that follow it) go through the masked-stats kernels
(kernels/masked_stats.py).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels.masked_stats import masked_batch_norm, masked_stats


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the row axis of [N, C] with a validity mask (float32)."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.1, eps: float = 1e-3):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, relu: bool = False,
                row_mask: bool = False, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return masked_batch_norm(x, mask, self.weight, self.bias, self.running_mean,
                                 self.running_var, self.training, self.momentum, self.eps,
                                 relu=relu, row_mask=row_mask)
