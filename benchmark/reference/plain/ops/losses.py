"""Detection losses (counterpart of robustpointclouds_tpu/ops/losses.py).

Sigmoid focal, smooth-L1 and softmax cross-entropy with explicit per-element
weights and an `avg_factor`, plus the sin-difference rotation trick — the
losses the reference's SECOND config sets (FocalLoss gamma 2 alpha 0.25,
SmoothL1Loss beta 1/9, direction CrossEntropyLoss). The JAX version picks
the cross-entropy label by a one-hot mask-sum, a TPU workaround; here a
gather gives the same exact value.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

Scalar = Union[torch.Tensor, float]


def _avg(total: torch.Tensor, avg_factor: Scalar) -> torch.Tensor:
    if isinstance(avg_factor, torch.Tensor):
        return total / torch.clamp(avg_factor, min=1.0)
    return total / max(avg_factor, 1.0)


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weight: Optional[torch.Tensor] = None, gamma: float = 2.0,
                       alpha: float = 0.25, avg_factor: Scalar = 1.0) -> torch.Tensor:
    """logits / one-hot targets [..., C] (background: all zeros), weight [...]."""
    p = torch.sigmoid(logits)
    ce = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    loss = (alpha_t * ((1.0 - p_t) ** gamma) * ce).sum(-1)
    if weight is not None:
        loss = loss * weight
    return _avg(loss.sum(), avg_factor)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   weight: Optional[torch.Tensor] = None, beta: float = 1.0 / 9.0,
                   avg_factor: Scalar = 1.0) -> torch.Tensor:
    """Huber / smooth-L1; pred and target [..., D], weight [...] or [..., D]."""
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    if weight is not None:
        if weight.dim() == loss.dim() - 1:
            weight = weight[..., None]
        loss = loss * weight
    return _avg(loss.sum(), avg_factor)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       avg_factor: Scalar = 1.0) -> torch.Tensor:
    """Softmax cross entropy with integer labels: logits [..., C], labels [...]."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if weight is not None:
        nll = nll * weight
    return _avg(nll.sum(), avg_factor)


def add_sin_difference(pred_rot: torch.Tensor, gt_rot: torch.Tensor):
    """(sin(p)cos(g), cos(p)sin(g)): their L1 residual is sin(p - g)."""
    return torch.sin(pred_rot) * torch.cos(gt_rot), torch.cos(pred_rot) * torch.sin(gt_rot)
