"""Rotated and circle NMS with static shapes, batched over leading dimensions.

Counterpart of robustpointclouds_tpu/ops/nms.py (`rotated_nms`,
`circle_nms`, `topk_nms_3d`). The JAX version runs one `fori_loop` sweep per
(sample, class) under vmap; here every leading row (sample, class or task)
is swept by one call of the operator rpc::greedy_keep (kernels/greedy_nms.py):
on the card one kernel launch a call, whatever N, on the CPU the plain loop
of N rounds; `greedy_nms.KERNEL_LAUNCHES` counts the calls by route. The
suppression relation is built here by torch ops. `top_k` is lax.top_k's
order (ties to the lower index) through a stable sort.
`CIRCLE_NMS_CALLS["sweep"]` counts the circle-NMS sweeps run (a host-side
program counter).
"""
from __future__ import annotations

import collections
from typing import Tuple, Union

import torch

from ..kernels.greedy_nms import greedy_keep
from . import boxes as box_ops

CIRCLE_NMS_CALLS: collections.Counter = collections.Counter()


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, ties to the lower index (lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _greedy_keep(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy keep-mask from a pairwise suppression relation [..., N, N]:
    boxes are sorted by descending score along the last axis of `valid`
    [..., N]; box i is suppressed when over[..., j, i] holds for an earlier
    *kept* box j. The leading dimensions go to the operator as one."""
    n = over.shape[-1]
    keep = greedy_keep(over.reshape(-1, n, n).contiguous(), valid.reshape(-1, n).contiguous())
    return keep.reshape(valid.shape)


def _suppression_sweep(affinity: torch.Tensor, valid: torch.Tensor, thr: float) -> torch.Tensor:
    """Greedy keep-mask from a pairwise affinity [..., N, N]: a box is
    suppressed when its affinity with an earlier *kept* box exceeds `thr`."""
    return _greedy_keep(affinity > thr, valid)


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


def circle_nms(centers: torch.Tensor, valid: torch.Tensor,
               radius: Union[float, torch.Tensor]) -> torch.Tensor:
    """Circle NMS (CenterPoint): centers [..., N, 2] sorted by descending
    score -> keep [..., N]. A float `radius` suppresses a box whose BEV
    centre lies closer than it to an earlier kept one (d^2 < radius^2); a
    tensor of valid's leading shape [...] is mmdet3d's per-row `min_radius`,
    compared with the squared distance (suppressed when d^2 <= min_radius)."""
    CIRCLE_NMS_CALLS["sweep"] += 1
    d2 = ((centers[..., :, None, :] - centers[..., None, :, :]) ** 2).sum(-1)
    if isinstance(radius, torch.Tensor):
        return _greedy_keep(d2 <= radius.to(d2.dtype)[..., None, None], valid)
    return _greedy_keep(d2 < radius ** 2, valid)


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
