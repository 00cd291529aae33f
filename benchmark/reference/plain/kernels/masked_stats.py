"""Masked statistics and the masked batch norm in plain torch, float32,
differentiable by autograd."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def masked_stats(x: torch.Tensor, mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean [C], biased var [C], count) of x's rows where mask is set."""
    xf = x.float()
    m = mask.to(torch.float32)[:, None]
    cnt = m.sum()
    safe = torch.clamp(cnt, min=1.0)
    mean = (xf * m).sum(0) / safe
    var = (((xf - mean) ** 2) * m).sum(0) / safe
    return mean, var, cnt


def masked_batch_norm(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                      training: bool, momentum: float = 0.1, eps: float = 1e-3,
                      relu: bool = False, row_mask: bool = False,
                      out_dtype: Optional[torch.dtype] = None, lowp: bool = False
                      ) -> torch.Tensor:
    """Batch statistics of the valid rows in training (running statistics
    updated in place), the running ones in eval; affine, ReLU, row mask."""
    if training:
        mean, var, _ = masked_stats(x, mask)
        with torch.no_grad():
            running_mean.mul_(1.0 - momentum).add_(momentum * mean)
            running_var.mul_(1.0 - momentum).add_(momentum * var)
    else:
        mean, var = running_mean, running_var
    y = (x.float() - mean) * torch.rsqrt(var + eps) * weight + bias
    if relu:
        y = torch.relu(y)
    if row_mask:
        y = torch.where(mask[:, None], y, torch.zeros_like(y))
    return y
