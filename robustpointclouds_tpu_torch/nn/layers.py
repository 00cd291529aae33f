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


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x [N, C] over the rows where mask [N] is True -> [C] float32."""
    return masked_stats(x, mask)[0]


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the row axis of [N, C] with a validity mask.

    Batch statistics of the valid rows in training (running stats updated
    with torch momentum 0.1, i.e. flax momentum 0.9, and the biased variance,
    as the JAX module keeps), running stats in eval. Statistics, running
    stats and parameters are float32; the output is cast to `dtype`. Padding
    rows are normalised too and masked downstream, or here with `row_mask`.
    The state_dict keys are BatchNorm1d's, so mmdet3d checkpoints load as
    they are.
    """

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.1, eps: float = 1e-3):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, mask: torch.Tensor, relu: bool = False,
                row_mask: bool = False, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The normalised x in `out_dtype` (the module's dtype by default),
        then ReLU (`relu`) and zeroed rows outside the mask (`row_mask`)."""
        return masked_batch_norm(x, mask, self.weight, self.bias, self.running_mean,
                                 self.running_var, self.training, self.momentum, self.eps,
                                 relu=relu, row_mask=row_mask, out_dtype=out_dtype or self.dtype)
