"""Anchor-head targets, losses and decoding (counterpart of robustpointclouds_tpu/models/detection.py).

Training: `anchor_head_targets` / `anchor_head_loss` (per-class Max-IoU
assignment, delta encoding, focal / smooth-L1 (sin difference) / direction
cross-entropy losses averaged over the positives). The host plan usually
carries the assignment (models/voxelnet.anchor_assign_plan), so the device
keeps only the elementwise target encoding. The JAX version gathers the
matched GT boxes by a one-hot matmul, a TPU workaround; here an index gather
gives the same exact values.

Serving: `anchor_head_predict` (decode + direction correction + per-class
rotated NMS). The JAX version vmaps `_predict_single` over the batch; here
the batch and the classes are leading dimensions of one computation, and
every sort is stable so ties resolve to the lower index as `lax.top_k` and
`jnp.argsort` do.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from ..ops import assigner, box_coder, boxes as box_ops, losses, nms


class AnchorHeadConfig(NamedTuple):
    num_classes: int = 3
    pos_iou_thr: Sequence[float] = (0.6, 0.35, 0.35)
    neg_iou_thr: Sequence[float] = (0.45, 0.2, 0.2)
    min_pos_iou: Sequence[float] = (0.45, 0.2, 0.2)
    cls_loss_weight: float = 1.0
    bbox_loss_weight: float = 2.0
    dir_loss_weight: float = 0.2
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    smooth_l1_beta: float = 1.0 / 9.0
    dir_offset: float = -math.pi / 2
    diff_rad_by_sin: bool = True
    # test cfg (reference ...kitti-3d-3class.py:113-120)
    score_thr: float = 0.1
    nms_pre: int = 100
    nms_iou_thr: float = 0.01
    max_num: int = 50
    use_rotate_nms: bool = True


def _direction_target(gt_yaw: torch.Tensor, dir_offset: float) -> torch.Tensor:
    """Bin yaw - dir_offset into 2 bins over [0, 2pi) (mmdet3d get_direction_target)."""
    offset_rot = torch.remainder(gt_yaw - dir_offset, 2 * math.pi)
    return torch.clamp(torch.floor(offset_rot / math.pi), 0, 1).to(torch.int32)


def anchor_head_targets(anchors: torch.Tensor, anchor_classes: torch.Tensor,
                        gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                        cfg: AnchorHeadConfig,
                        assign_res: Optional[assigner.AssignResult] = None):
    """Batched targets: anchors [A, 7]; GTs padded [B, G, ...] -> (cls one-hot
    [B, A, C], cls weights [B, A], bbox targets [B, A, 7], bbox weights
    [B, A], direction targets [B, A]). `assign_res`: a precomputed
    assignment [B, A] (the plan's "assign" group), else it is computed here."""
    res = assign_res
    if res is None:
        res = assigner.assign(anchors, anchor_classes, gt_boxes, gt_labels, gt_mask,
                              cfg.pos_iou_thr, cfg.neg_iou_thr, cfg.min_pos_iou)
    matched = res.matched_gt.long()                                   # [B, A]
    matched_boxes = torch.gather(gt_boxes, 1, matched[..., None].expand(*matched.shape, 7))
    bbox_targets = box_coder.encode(matched_boxes, anchors[None].expand_as(matched_boxes))
    dir_targets = _direction_target(matched_boxes[..., 6], cfg.dir_offset)
    cls_ids = torch.where(res.pos_mask, res.labels.long(),
                          torch.full_like(matched, cfg.num_classes))
    cls_onehot = torch.nn.functional.one_hot(cls_ids, cfg.num_classes + 1)[..., :cfg.num_classes]
    cls_weights = (res.pos_mask | res.neg_mask).to(torch.float32)
    bbox_weights = res.pos_mask.to(torch.float32)
    return cls_onehot.to(torch.float32), cls_weights, bbox_targets, bbox_weights, dir_targets


def anchor_head_loss(cls_scores: torch.Tensor, bbox_preds: torch.Tensor, dir_preds: torch.Tensor,
                     anchors: torch.Tensor, anchor_classes: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                     cfg: AnchorHeadConfig,
                     assign: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Batched detection loss -> dict(loss_cls, loss_bbox, loss_dir, num_pos).

    cls_scores [B, H, W, A, C], bbox_preds [B, H, W, A, 7], dir_preds
    [B, H, W, A, 2]; anchors [N, 7] flattened, anchor_classes [N]; gt_* [B, G, ...].
    `assign`: the host plan's {labels, matched_gt, pos_mask, neg_mask} [B, N].
    """
    b = cls_scores.shape[0]
    n = anchors.shape[0]
    cls_scores = cls_scores.reshape(b, n, -1)
    bbox_preds = bbox_preds.reshape(b, n, 7)
    dir_preds = dir_preds.reshape(b, n, 2)
    res = None
    if assign is not None:
        res = assigner.AssignResult(assign["labels"], assign["matched_gt"], None,
                                    assign["pos_mask"], assign["neg_mask"])
    cls_t, cls_w, bbox_t, bbox_w, dir_t = anchor_head_targets(
        anchors, anchor_classes, gt_boxes, gt_labels, gt_mask, cfg, res)

    num_pos = torch.clamp(bbox_w.sum(), min=1.0)
    loss_cls = cfg.cls_loss_weight * losses.sigmoid_focal_loss(
        cls_scores, cls_t, cls_w, cfg.focal_gamma, cfg.focal_alpha, avg_factor=num_pos)
    if cfg.diff_rad_by_sin:
        pred_rot, tgt_rot = losses.add_sin_difference(bbox_preds[..., 6], bbox_t[..., 6])
        bbox_preds = torch.cat([bbox_preds[..., :6], pred_rot[..., None]], -1)
        bbox_t = torch.cat([bbox_t[..., :6], tgt_rot[..., None]], -1)
    loss_bbox = cfg.bbox_loss_weight * losses.smooth_l1_loss(
        bbox_preds, bbox_t, bbox_w, cfg.smooth_l1_beta, avg_factor=num_pos)
    loss_dir = cfg.dir_loss_weight * losses.cross_entropy_loss(
        dir_preds, dir_t, bbox_w, avg_factor=num_pos)
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox, "loss_dir": loss_dir,
            "num_pos": num_pos}


_top_k = nms.top_k


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., N, D] gathered along N by idx [..., K] -> [..., K, D]."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _predict_single(cls_scores, bbox_preds, dir_preds, anchors, cfg: AnchorHeadConfig):
    """Decode [B, N, ...] -> fixed-size detections via per-class NMS (batched
    over B): rotated BEV NMS (the circle NMS of `use_rotate_nms` off is not
    kept here)."""
    if not cfg.use_rotate_nms:
        raise ValueError("the reference decodes with rotated NMS only")
    scores = torch.sigmoid(cls_scores)  # [B, N, C]
    b, n, c = scores.shape
    pre = min(cfg.nms_pre, n)
    _, top_idx = _top_k(scores.max(-1).values, pre)          # [B, pre]
    sel_scores = _take(scores, top_idx)                        # [B, pre, C]
    sel_boxes = box_coder.decode(_take(bbox_preds, top_idx), anchors[top_idx])
    sel_dir = _take(dir_preds, top_idx).argmax(-1)

    # direction correction (mmdet3d Anchor3DHead.predict_by_feat tail)
    yaw = sel_boxes[..., 6]
    dir_rot = box_ops.limit_period(yaw - cfg.dir_offset, 0.0, math.pi)
    yaw = dir_rot + cfg.dir_offset + math.pi * sel_dir.to(yaw.dtype)
    sel_boxes = torch.cat([sel_boxes[..., :6], yaw[..., None]], -1)

    # every (sample, class) row sorted by its class score, then one NMS sweep
    cls_sc = sel_scores.transpose(1, 2)                        # [B, C, pre]
    order = torch.argsort(-cls_sc, dim=-1, stable=True)
    boxes_c = _take(sel_boxes[:, None].expand(b, c, pre, 7), order)
    sc_sorted = torch.gather(cls_sc, -1, order)
    keep = nms.rotated_nms(box_ops.boxes3d_to_bev(boxes_c), None,
                           sc_sorted > cfg.score_thr, cfg.nms_iou_thr)
    all_scores = torch.where(keep, sc_sorted, torch.full_like(sc_sorted, -1.0)).reshape(b, c * pre)
    all_boxes = boxes_c.reshape(b, c * pre, 7)
    all_labels = torch.arange(c, dtype=torch.int32, device=scores.device).repeat_interleave(pre)
    final_scores, sel = _top_k(all_scores, min(cfg.max_num, c * pre))
    return _take(all_boxes, sel), final_scores, all_labels[sel], final_scores > 0.0


def anchor_head_predict(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                        dir_preds: torch.Tensor, anchors: torch.Tensor,
                        cfg: AnchorHeadConfig):
    """Batched decode + NMS: returns (boxes [B, K, 7], scores, labels, valid)."""
    b = cls_scores.shape[0]
    n = anchors.shape[0]
    return _predict_single(cls_scores.reshape(b, n, -1), bbox_preds.reshape(b, n, 7),
                           dir_preds.reshape(b, n, 2), anchors, cfg)
