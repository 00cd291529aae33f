"""Rotated NMS with static shapes, batched over leading dimensions.

Counterpart of robustpointclouds_tpu/ops/nms.py (`rotated_nms`). The JAX
version runs one `fori_loop` sweep per (sample, class) under vmap; here one
Python loop of N steps sweeps every leading row (sample, class or task) at
once, so a request costs N small launches instead of B x classes x N.
`top_k` is lax.top_k's order (ties to the lower index) through a stable
sort.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import boxes as box_ops


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, ties to the lower index (lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _suppression_sweep(affinity: torch.Tensor, valid: torch.Tensor, thr: float) -> torch.Tensor:
    """Greedy keep-mask from a pairwise affinity [..., N, N].

    Boxes are sorted by descending score along the last axis of `valid`
    [..., N]; a box is suppressed when its affinity with an earlier *kept*
    box exceeds `thr`.
    """
    n = affinity.shape[-1]
    over = affinity > thr
    idx = torch.arange(n, device=affinity.device)
    keep = torch.zeros_like(valid)
    for i in range(n):
        earlier = (idx < i) & keep
        suppressed = torch.any(earlier & over[..., :, i], dim=-1)
        keep[..., i] = valid[..., i] & ~suppressed
    return keep


def rotated_nms(
    bev_boxes: torch.Tensor,
    scores,
    valid: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Rotated-BEV NMS. bev_boxes [..., N, 5] sorted by descending score -> keep [..., N].

    `scores` is unused (the order carries it), as in the JAX signature.
    """
    iou = box_ops.rotated_bev_iou(bev_boxes, bev_boxes)
    return _suppression_sweep(iou, valid, iou_threshold)
