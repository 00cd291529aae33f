"""Masked per-channel statistics and their VJP: the port of the Pallas `masked_stats`.

`masked_stats(x [N, C], mask [N]) -> (mean [C], var [C], count)`, all
float32: mean and biased variance over the rows where mask is True, and the
count of those rows (mean and var are 0 when no row is valid). The port runs
it under the perturber's std normalisation and its regulariser statistics
(nn/perturber.py) and under MaskedBatchNorm in training (nn/layers.py).

It is differentiable in x through the Pallas kernel's analytic VJP
(robustpointclouds_tpu/kernels/masked_stats.py:102 `_stats_bwd`):
    dx = m * (g_mean + 2 * g_var * (x - mean)) / max(cnt, 1)
with no gradient to the mask or the count.

A CUDA tensor launches the Triton kernels (kernels/masked_stats_triton.py:
the forward in two passes merged by Chan's formula, the VJP in one fused
elementwise pass); a CPU tensor takes the plain versions `masked_stats_ref`
(the two-pass form of robustpointclouds_tpu/nn/layers.masked_mean) and
`masked_stats_bwd_ref`. Anything else raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def masked_stats_ref(x: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: masked mean, then the masked mean of squared deviations."""
    xf = x.float()
    m = mask.to(torch.float32)[:, None]
    cnt = m.sum()
    safe = torch.clamp(cnt, min=1.0)
    mean = (xf * m).sum(0) / safe
    var = (((xf - mean) ** 2) * m).sum(0) / safe
    return mean, var, cnt


def masked_stats_bwd_ref(x: torch.Tensor, mask: torch.Tensor, mean: torch.Tensor,
                         cnt: torch.Tensor, g_mean: Optional[torch.Tensor],
                         g_var: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the VJP; dx in x's dtype."""
    d = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    if g_mean is not None:
        d = d + g_mean.float()[None, :]
    if g_var is not None:
        d = d + 2.0 * g_var.float()[None, :] * (x.float() - mean[None, :])
    m = mask.to(torch.float32)[:, None]
    return (m * d / torch.clamp(cnt, min=1.0)).to(x.dtype)


def _check(name: str, x: torch.Tensor, mask: torch.Tensor) -> None:
    if not (x.is_cuda and mask.device == x.device):
        raise ValueError(f"{name}: x and mask must lie on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous float32/bfloat16 [N, C], "
                         f"got {x.dtype} {tuple(x.shape)}")
    if mask.dtype != torch.bool or mask.shape != x.shape[:1] or not mask.is_contiguous():
        raise ValueError(f"{name}: mask must be a contiguous bool [N]")
    if x.shape[0] == 0:
        raise ValueError(f"{name}: x has no rows")


def _stats(x: torch.Tensor, mask: torch.Tensor):
    if x.device.type == "cpu":
        return masked_stats_ref(x, mask)
    _check("masked_stats", x, mask)
    from . import masked_stats_triton

    n, c = x.shape
    mean = torch.empty((c,), dtype=torch.float32, device=x.device)
    var = torch.empty((c,), dtype=torch.float32, device=x.device)
    cnt = torch.empty((), dtype=torch.float32, device=x.device)
    masked_stats_triton.launch(x, mask.view(torch.uint8), mean, var, cnt.view(1), n, c)
    masked_stats.launches += 1
    return mean, var, cnt


def masked_stats_bwd(x: torch.Tensor, mask: torch.Tensor, mean: torch.Tensor, cnt: torch.Tensor,
                     g_mean: Optional[torch.Tensor], g_var: Optional[torch.Tensor]) -> torch.Tensor:
    """dx [N, C] in x's dtype; a missing g_mean or g_var counts as zero."""
    if x.device.type == "cpu":
        return masked_stats_bwd_ref(x, mask, mean, cnt, g_mean, g_var)
    _check("masked_stats_bwd", x, mask)
    from . import masked_stats_triton

    n, c = x.shape
    g_mean = None if g_mean is None else g_mean.float().contiguous()
    g_var = None if g_var is None else g_var.float().contiguous()
    dx = torch.empty_like(x)
    masked_stats_triton.launch_bwd(x, mask.view(torch.uint8), mean.contiguous(),
                                   cnt.reshape(1), g_mean, g_var, dx, n, c)
    masked_stats_bwd.launches += 1
    return dx


class MaskedStatsFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask):
        mean, var, cnt = _stats(x, mask)
        ctx.save_for_backward(x, mask, mean, cnt)
        ctx.mark_non_differentiable(cnt)
        ctx.set_materialize_grads(False)
        return mean, var, cnt

    @staticmethod
    def backward(ctx, g_mean, g_var, _g_cnt):
        if not ctx.needs_input_grad[0] or (g_mean is None and g_var is None):
            return None, None
        x, mask, mean, cnt = ctx.saved_tensors
        return masked_stats_bwd(x, mask, mean, cnt, g_mean, g_var), None


def masked_stats(x: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean [C], var [C], count) of x's valid rows, float32; differentiable in x.

    Only an input that needs a gradient goes through the autograd Function;
    serving and the perturber's no-grad statistics launch the kernel directly."""
    if x.requires_grad and torch.is_grad_enabled():
        return MaskedStatsFunction.apply(x, mask)
    return _stats(x, mask)


masked_stats.launches = 0
masked_stats_bwd.launches = 0
