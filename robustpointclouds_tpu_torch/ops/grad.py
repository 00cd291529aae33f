"""Gradient-surgery primitives for single-backward min-max training.

Counterpart of robustpointclouds_tpu/ops/grad.grad_scale.
"""
from __future__ import annotations

import torch


class GradScale(torch.autograd.Function):
    """Identity in the forward; scales the incoming gradient by `scale` in the
    backward (scale = -1 is the gradient-reversal layer on the adversary's
    perturbation delta)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale) -> torch.Tensor:
        # a float, or a 0-d tensor (the trainer's device-side kill switch
        # enters the factor without a host sync)
        ctx.scale = scale if isinstance(scale, torch.Tensor) else float(scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g * ctx.scale, None


def grad_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    return GradScale.apply(x, scale)
