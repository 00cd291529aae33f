"""Max-IoU anchor-to-GT assignment (counterpart of robustpointclouds_tpu/ops/assigner.py).

mmdet3d's Max3DIoUAssigner + BboxOverlapsNearest3D with per-class
thresholds, over padded GTs with a validity mask. Labels per anchor: class
id (positive), -1 (negative), -2 (ignore). The JAX version vmaps one sample;
here the batch is a leading dimension. Ties resolve as in JAX: argmax takes
the first index, and the GT-wise forced positives are a scatter-max in which
a GT that forces nothing writes False / -1 to anchor 0. On the same float32
inputs the result is bit-equal to the JAX assignment.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..core.device import device_constant
from . import boxes as box_ops


class AssignResult(NamedTuple):
    labels: torch.Tensor      # [..., A] int32: class id, -1 neg, -2 ignore
    matched_gt: torch.Tensor  # [..., A] int32 index into the GTs (valid where pos)
    max_iou: torch.Tensor     # [..., A] float32
    pos_mask: torch.Tensor    # [..., A] bool
    neg_mask: torch.Tensor    # [..., A] bool


def assign(anchors: torch.Tensor, anchor_classes: torch.Tensor, gt_boxes: torch.Tensor,
           gt_labels: torch.Tensor, gt_mask: torch.Tensor, pos_iou_thr: Sequence[float],
           neg_iou_thr: Sequence[float], min_pos_iou: Sequence[float]) -> AssignResult:
    """anchors [A, 7], anchor_classes [A]; gt_boxes [B, G, 7], gt_labels /
    gt_mask [B, G] -> per-anchor assignment [B, A]."""
    num_classes = len(pos_iou_thr)
    dev = anchors.device
    b, g = gt_labels.shape
    gt_labels = gt_labels.long()
    anchor_classes = anchor_classes.long()
    iou = box_ops.nearest_bev_iou(anchors[None], gt_boxes)                # [B, A, G]
    class_match = anchor_classes[None, :, None] == gt_labels[:, None, :]
    iou = torch.where(class_match & gt_mask[:, None, :], iou, torch.full_like(iou, -1.0))

    max_iou, argmax_gt = iou.max(dim=2)          # first index among ties
    pos_thr = device_constant(pos_iou_thr, torch.float32, dev)[anchor_classes]
    neg_thr = device_constant(neg_iou_thr, torch.float32, dev)[anchor_classes]
    pos = max_iou >= pos_thr[None]
    neg = max_iou < neg_thr[None]  # includes anchors with no same-class GT (iou -1)

    # GT-wise forcing: each GT claims its best same-class anchor when that
    # IoU reaches the class's min_pos_iou
    gt_best_iou, gt_best_anchor = iou.max(dim=1)                       # [B, G]
    min_thr = device_constant(min_pos_iou, torch.float32, dev)[
        torch.clamp(gt_labels, 0, num_classes - 1)]
    min_thr = torch.where(gt_mask, min_thr, torch.full_like(min_thr, float("inf")))
    force = gt_mask & (gt_best_iou >= min_thr)
    target = torch.where(force, gt_best_anchor, torch.zeros_like(gt_best_anchor))
    forced_pos = torch.zeros(pos.shape, dtype=torch.int32, device=dev).scatter_reduce(
        1, target, force.to(torch.int32), reduce="amax").bool()
    gt_ids = torch.arange(g, dtype=torch.int32, device=dev).expand(b, g)
    forced_gt_idx = torch.full(pos.shape, -1, dtype=torch.int32, device=dev).scatter_reduce(
        1, target, torch.where(force, gt_ids, torch.full_like(gt_ids, -1)), reduce="amax")

    pos = pos | forced_pos
    neg = neg & ~pos
    matched = torch.where(forced_pos & (forced_gt_idx >= 0), forced_gt_idx,
                          argmax_gt.to(torch.int32))
    matched_labels = torch.gather(gt_labels, 1, matched.long()).to(torch.int32)
    labels = torch.where(pos, matched_labels,
                         torch.where(neg, torch.full_like(matched_labels, -1),
                                     torch.full_like(matched_labels, -2)))
    return AssignResult(labels, matched, max_iou, pos, neg)
