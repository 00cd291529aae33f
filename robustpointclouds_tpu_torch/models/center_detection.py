"""CenterPoint targets, loss and decoding (counterpart of robustpointclouds_tpu/models/center_detection.py).

mmdet3d CenterHead's `loss` / `predict_by_feat` as the reference's NuScenes
path runs them, with static shapes: each task carries up to `max_objs`
target rows with a validity mask, and decoding is a per-task dense top-k
followed by circle NMS (the reference checkpoint's `circlenms` variant).

The targets are a pure function of the GTs, so they are built on the host
in CPU torch beside the sparse plan (train/centerpoint_loop.CenterPointPlanBuilder,
in the input pipeline's prefetch thread), or on the card inside the inline
train step; each gaussian is drawn only
inside its 3-sigma window, which holds every cell the JAX package's
full-grid field leaves non-zero. The loss and the decode run on the
device. Sorts are stable, so ties resolve to the lower index as `lax.top_k`
and `jnp.argsort` do.

`TARGET_CALLS` counts, on the host, the heatmap splats drawn ("splat") and
the reads of a device value to the host they make ("host_read": whether
any object is valid, the largest radius); on the card each read waits for
the device.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.device import device_constant
from ..ops import losses as loss_ops
from ..ops import nms as nms_ops

TARGET_CALLS: collections.Counter = collections.Counter()


class CenterHeadConfig(NamedTuple):
    tasks: Tuple[Tuple[str, ...], ...]
    point_cloud_range: Tuple[float, ...] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    voxel_size: Tuple[float, float] = (0.1, 0.1)     # xy only (BEV)
    out_factor: int = 8                               # BEV stride of the head
    max_objs: int = 100
    gaussian_overlap: float = 0.1
    min_radius: int = 2
    heatmap_weight: float = 1.0
    bbox_weight: float = 0.25
    code_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2)
    # test cfg
    score_thr: float = 0.1
    nms_pre: int = 500
    max_per_task: int = 83
    # a float: suppress a centre closer than it to a kept one (the JAX
    # package's rule); a tuple, one a task: mmdet3d's test_cfg `min_radius`,
    # compared with the squared centre distance (suppress when d^2 <= r)
    circle_radius: Union[float, Tuple[float, ...]] = 4.0

    @property
    def num_classes(self) -> int:
        return sum(len(t) for t in self.tasks)

    def class_to_task(self) -> List[Tuple[int, int]]:
        """class id -> (task idx, idx within task)."""
        return [(t, j) for t, names in enumerate(self.tasks) for j in range(len(names))]


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b with b as a tensor on a's device: CUDA turns a division by a host
    scalar into a multiply by its reciprocal, which can round differently
    from the CPU's division."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def gaussian_radius(dx: torch.Tensor, dy: torch.Tensor, min_overlap: float) -> torch.Tensor:
    """CornerNet radius rule on BEV extents (in feature cells)."""
    b1 = dy + dx
    c1 = _div(dx * dy * (1 - min_overlap), 1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * 1.0 * c1, min=0.0))) / 2
    b2 = 2 * (dy + dx)
    c2 = (1 - min_overlap) * dx * dy
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 4 * 4.0 * c2, min=0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (dy + dx)
    c3 = (min_overlap - 1) * dx * dy
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def _splat_heatmap(h: int, w: int, c: int, cx: torch.Tensor, cy: torch.Tensor,
                   radius: torch.Tensor, cls: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Max of the objects' gaussians on an [H, W, C] map (float32). Object o
    adds exp(-d^2 / (2 sigma^2)), sigma = max(r, 1) / 3, cut below exp(-4.5)
    (3 sigma: d <= max(r, 1)), in its class's channel; each is evaluated
    only on a window of half-width max(r, 1) + 1 cells around its centre."""
    TARGET_CALLS["splat"] += 1
    TARGET_CALLS["host_read"] += 1
    hm = torch.zeros(h * w * c, dtype=torch.float32, device=cx.device)
    if not bool(valid.any()):
        return hm.reshape(h, w, c)
    cx, cy, radius, cls = cx[valid], cy[valid], radius[valid], cls[valid].long()
    sigma = _div(torch.clamp(radius, min=1.0), 3.0)
    TARGET_CALLS["host_read"] += 1
    half = int(torch.clamp(radius, min=1.0).max().item()) + 1
    off = torch.arange(-half, half + 1, dtype=torch.float32, device=cx.device)
    # the cells of each window: the integer cells around the truncated centre
    xs = (torch.floor(cx)[:, None] + off[None, :])[:, None, :]     # [n, 1, win]
    ys = (torch.floor(cy)[:, None] + off[None, :])[:, :, None]     # [n, win, 1]
    g = torch.exp(-((xs - cx[:, None, None]) ** 2 + (ys - cy[:, None, None]) ** 2)
                  / (2 * sigma[:, None, None] ** 2))
    g = torch.where(g < math.exp(-4.5), torch.zeros_like(g), g)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    flat = ((ys * w + xs).long() * c + cls[:, None, None]).expand_as(g)
    hm.scatter_reduce_(0, flat[inside], g[inside], reduce="amax")
    return hm.reshape(h, w, c)


def centerpoint_targets_single(gt_boxes, gt_labels, gt_mask, gt_vel,
                               feat_size: Tuple[int, int], cfg: CenterHeadConfig
                               ) -> List[Dict[str, torch.Tensor]]:
    """Targets of one sample: per task a heatmap [H, W, C_t] and up to
    max_objs regression rows (`anno` [M, 10]: dxy, z, log-dims, sin, cos,
    vel), their flat cells `pos` [M] and validity `mask` [M]. Tensors are
    taken on their device, arrays on the CPU."""
    dev = gt_boxes.device if isinstance(gt_boxes, torch.Tensor) else torch.device("cpu")

    def as_t(x, dtype):
        return (x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))).to(
            device=dev, dtype=dtype)

    gt_boxes = as_t(gt_boxes, torch.float32)
    gt_labels = as_t(gt_labels, torch.int64)
    gt_mask = as_t(gt_mask, torch.bool)
    gt_vel = as_t(gt_vel, torch.float32)
    h, w = feat_size
    pcr = cfg.point_cloud_range
    vx, vy = cfg.voxel_size
    stride = cfg.out_factor
    mapping = cfg.class_to_task()
    task_of_class = torch.tensor([m[0] for m in mapping], device=dev)
    idx_in_task = torch.tensor([m[1] for m in mapping], device=dev)

    cx = _div(gt_boxes[:, 0] - pcr[0], vx * stride)
    cy = _div(gt_boxes[:, 1] - pcr[1], vy * stride)
    in_grid = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h) & gt_mask
    dxf = _div(gt_boxes[:, 3], vx * stride)
    dyf = _div(gt_boxes[:, 4], vy * stride)
    radius = torch.clamp(torch.floor(gaussian_radius(dxf, dyf, cfg.gaussian_overlap)),
                         min=float(cfg.min_radius))
    safe = torch.clamp(gt_labels, 0, cfg.num_classes - 1)
    g_task, g_cls = task_of_class[safe], idx_in_task[safe]

    outs = []
    for t, names in enumerate(cfg.tasks):
        tmask = in_grid & (g_task == t)
        # this task's objects first, each group in its original order
        sel = torch.argsort((~tmask).to(torch.int8), stable=True)[:cfg.max_objs]
        v = tmask[sel]
        bx, by = cx[sel], cy[sel]
        ix = torch.clamp(bx.to(torch.int32), 0, w - 1)
        iy = torch.clamp(by.to(torch.int32), 0, h - 1)
        boxes = gt_boxes[sel]
        anno = torch.cat([(bx - ix)[:, None], (by - iy)[:, None], boxes[:, 2:3],
                          torch.log(torch.clamp(boxes[:, 3:6], min=1e-3)),
                          torch.sin(boxes[:, 6:7]), torch.cos(boxes[:, 6:7]), gt_vel[sel]], 1)
        hm = _splat_heatmap(h, w, len(names), bx, by, radius[sel], g_cls[sel], v)
        pos = iy * w + ix
        # exactly 1.0 at the centre cell marks the positives of the focal loss
        hm.view(h * w, len(names))[pos[v].long(), g_cls[sel][v]] = 1.0
        outs.append({"heatmap": hm, "anno": anno, "pos": pos, "mask": v})
    return outs


def centerpoint_targets(gt_boxes, gt_labels, gt_mask, gt_vel, feat_size: Tuple[int, int],
                        cfg: CenterHeadConfig) -> List[Dict[str, torch.Tensor]]:
    """Batched targets as a plan group: per task {heatmap [B, H, W, C_t],
    anno [B, M, 10], pos [B, M] int32, mask [B, M]}, tensors on the GTs'
    device (the CPU for arrays)."""
    per = [centerpoint_targets_single(gt_boxes[b], gt_labels[b], gt_mask[b], gt_vel[b],
                                      feat_size, cfg) for b in range(len(gt_boxes))]
    return [{k: torch.stack([p[t][k] for p in per]) for k in per[0][t]}
            for t in range(len(cfg.tasks))]


def _reg_map(pred: Dict[str, torch.Tensor]) -> torch.Tensor:
    b, h, w = pred["heatmap"].shape[:3]
    return torch.cat([pred["reg"], pred["height"], pred["dim"], pred["rot"], pred["vel"]],
                     -1).reshape(b, h * w, 10)


def centerpoint_loss(preds: Sequence[Dict[str, torch.Tensor]],
                     targets: Sequence[Dict[str, torch.Tensor]],
                     cfg: CenterHeadConfig) -> Dict[str, torch.Tensor]:
    """Batched CenterPoint loss over all tasks: the logit-space gaussian
    focal loss on the heatmaps and the code-weighted L1 of the regression
    maps at the positive cells, each averaged over the task's positives.
    `targets`: the plan's "targets" group (centerpoint_targets), on the
    device."""
    h, w = preds[0]["heatmap"].shape[1:3]
    cw = torch.tensor(cfg.code_weights, dtype=torch.float32, device=preds[0]["heatmap"].device)
    total_hm = total_bbox = torch.zeros((), device=cw.device)
    logs: Dict[str, torch.Tensor] = {}
    for t, pred in enumerate(preds):
        tgt = targets[t]
        mask = tgt["mask"].to(torch.float32)
        num_pos = torch.clamp(mask.sum(), min=1.0)
        l_hm = loss_ops.gaussian_focal_loss_logits(pred["heatmap"], tgt["heatmap"],
                                                   avg_factor=num_pos)
        pos = torch.clamp(tgt["pos"].long(), 0, h * w - 1)
        rows = torch.gather(_reg_map(pred), 1, pos[..., None].expand(*pos.shape, 10))
        diff = torch.abs(rows - tgt["anno"]) * cw
        diff = torch.where(torch.isfinite(diff), diff, torch.zeros_like(diff))
        l_bbox = (diff * mask[..., None]).sum() / num_pos
        total_hm = total_hm + cfg.heatmap_weight * l_hm
        total_bbox = total_bbox + cfg.bbox_weight * l_bbox
        logs[f"task{t}_loss_heatmap"] = l_hm
        logs[f"task{t}_loss_bbox"] = l_bbox
    logs["loss_heatmap"] = total_hm
    logs["loss_bbox"] = total_bbox
    return logs


def centerpoint_decode(preds: Sequence[Dict[str, torch.Tensor]], cfg: CenterHeadConfig):
    """All tasks -> padded detections (boxes [B, K, 9] as (x, y, z, dx, dy,
    dz, yaw, vx, vy), scores, labels int32, valid), K = the tasks' summed
    min(max_per_task, nms_pre). Tasks of one top-k size share one circle-NMS
    sweep; `cfg.circle_radius` a tuple gives each task its own radius."""
    if not isinstance(cfg.circle_radius, (int, float)) and len(cfg.circle_radius) != len(preds):
        raise ValueError(f"circle_radius gives {len(cfg.circle_radius)} radii for "
                         f"{len(preds)} tasks")
    pcr = cfg.point_cloud_range
    vx, vy = cfg.voxel_size
    stride = cfg.out_factor
    base_cls = np.cumsum([0] + [len(t) for t in cfg.tasks])
    b, h, w = preds[0]["heatmap"].shape[:3]
    cand = []
    for t, pred in enumerate(preds):
        c = pred["heatmap"].shape[-1]
        k = min(cfg.nms_pre, h * w * c)
        scores, flat = nms_ops.top_k(torch.sigmoid(pred["heatmap"]).reshape(b, h * w * c), k)
        cell = flat // c
        cls = (flat % c + int(base_cls[t])).to(torch.int32)
        iy = (cell // w).to(torch.float32)
        ix = (cell % w).to(torch.float32)
        rows = torch.gather(_reg_map(pred), 1, cell[..., None].expand(*cell.shape, 10))
        x = (ix + rows[..., 0]) * vx * stride + pcr[0]
        y = (iy + rows[..., 1]) * vy * stride + pcr[1]
        dims = torch.exp(torch.clamp(rows[..., 3:6], -8.0, 8.0))
        yaw = torch.atan2(rows[..., 6], rows[..., 7])
        boxes = torch.cat([x[..., None], y[..., None], rows[..., 2:3], dims, yaw[..., None],
                           rows[..., 8:10]], -1)
        cand.append((boxes, scores, cls))
    keeps: Dict[int, torch.Tensor] = {}
    for k in sorted({s.shape[-1] for _, s, _ in cand}):
        group = [t for t, (_, s, _) in enumerate(cand) if s.shape[-1] == k]
        centers = torch.stack([cand[t][0][..., :2] for t in group], 1)   # [B, T, k, 2]
        scores = torch.stack([cand[t][1] for t in group], 1)
        radius = cfg.circle_radius
        if not isinstance(radius, (int, float)):
            radius = device_constant([float(radius[t]) for t in group], torch.float32,
                                     centers.device).expand(b, len(group))
        keep = nms_ops.circle_nms(centers, scores > cfg.score_thr, radius)
        keeps.update({t: keep[:, i] for i, t in enumerate(group)})
    out_b, out_s, out_l, out_v = [], [], [], []
    for t, (boxes, scores, cls) in enumerate(cand):
        m = min(cfg.max_per_task, scores.shape[-1])
        top_s, sel = nms_ops.top_k(torch.where(keeps[t], scores, torch.full_like(scores, -1.0)), m)
        out_b.append(torch.gather(boxes, 1, sel[..., None].expand(*sel.shape, 9)))
        out_s.append(top_s)
        out_l.append(torch.gather(cls, 1, sel))
        out_v.append(top_s > 0.0)
    return (torch.cat(out_b, 1), torch.cat(out_s, 1), torch.cat(out_l, 1), torch.cat(out_v, 1))
