"""Rotated and circle NMS with static shapes, batched over leading dimensions.

Counterpart of robustpointclouds_tpu/ops/nms.py (`rotated_nms`,
`circle_nms`, `topk_nms_3d`). The JAX version runs one `fori_loop` sweep per
(sample, class) under vmap; here one Python loop of N steps sweeps every
leading row (sample, class or task) at once, so a request costs N small
launches instead of B x classes x N. `top_k` is lax.top_k's order (ties to
the lower index) through a stable sort.
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


def circle_nms(centers: torch.Tensor, valid: torch.Tensor, radius: float) -> torch.Tensor:
    """Circle NMS (CenterPoint): a box is suppressed when its BEV centre lies
    closer than `radius` to an earlier kept one. centers [..., N, 2] sorted by
    descending score -> keep [..., N]."""
    d2 = ((centers[..., :, None, :] - centers[..., None, :, :]) ** 2).sum(-1)
    # affinity = -dist^2, threshold = -radius^2 (suppress when closer)
    return _suppression_sweep(-d2, valid, -(radius ** 2))


def topk_nms_3d(boxes3d: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                valid: torch.Tensor, *, score_thr: float = 0.1, nms_pre: int = 100,
                iou_thr: float = 0.01, max_num: int = 50, use_rotate_nms: bool = True,
                circle_radius: float = 4.0):
    """Score filter -> top-k -> rotated or circle NMS -> cap at max_num.

    boxes3d [..., A, 7], scores / labels / valid [..., A] -> (boxes
    [..., max_num, 7], scores, labels, mask), fixed-size with `mask` marking
    the real detections."""
    nms_pre = min(nms_pre, boxes3d.shape[-2])
    scores = torch.where(valid & (scores > score_thr), scores, torch.full_like(scores, -1.0))
    top_scores, top_idx = top_k(scores, nms_pre)
    top_boxes = torch.gather(boxes3d, -2, top_idx[..., None].expand(*top_idx.shape, 7))
    top_labels = torch.gather(labels, -1, top_idx)
    top_valid = top_scores > 0.0
    if use_rotate_nms:
        keep = rotated_nms(box_ops.boxes3d_to_bev(top_boxes), top_scores, top_valid, iou_thr)
    else:
        keep = circle_nms(top_boxes[..., :2], top_valid, circle_radius)
    kept = torch.where(keep, top_scores, torch.full_like(top_scores, -1.0))
    final_scores, sel = top_k(kept, min(max_num, nms_pre))
    return (torch.gather(top_boxes, -2, sel[..., None].expand(*sel.shape, 7)), final_scores,
            torch.gather(top_labels, -1, sel), final_scores > 0.0)
