"""CenterPoint's targets, losses and decode in plain float32 torch: the
reference of the configuration's training objective and of its test-time
decode with circle NMS.

Targets, per frame and task, as mmdet3d's CenterHead.get_targets_single:
the task's boxes in their order, at most `max_objs`; a box whose centre
falls in the BEV grid gets a row (the centre's offset from its cell, z,
log dims, sin and cos of the yaw, the velocity), its flat cell and a mask
bit, and a gaussian on its class's heatmap, the heatmaps of one class
merged by their maximum; the centre cell is set to exactly 1.

Losses: mmdet3d's GaussianFocalLoss (alpha 2, gamma 4) on the heatmap over
the task's positives, and the code-weighted L1 of the regression maps at
the positive cells over the same count.

Decode, per task: the top `max_num` of the heatmap's sigmoid over its
cells and classes, the boxes from the regression maps at those cells, the
candidates above `score_threshold` through circle NMS (mmdet3d's
`circle_nms`: in score order, a candidate is dropped when its squared BEV
centre distance to a kept one is at most the task's `min_radius`), then the
first `post_max_size` kept. Padded outputs as the program's: (boxes
[B, K, 9], scores, labels, valid), K = the tasks' summed post_max_size.

Departures from the published description, each the program's (the repo's
JAX package's) own rule, kept so that the comparison measures rounding:
  * the gaussian is centred on the box's fractional centre with sigma =
    max(r, 1) / 3 and cut below exp(-4.5); mmdet3d centres it on the
    integer cell with sigma = (2r + 1) / 6;
  * a box counts when its fractional centre lies in [0, W) x [0, H);
    mmdet3d truncates first, so a centre in (-1, 0) still counts there;
  * the focal loss is taken in logit space (log-sigmoid), where mmdet3d
    clamps the sigmoid to [1e-4, 1 - 1e-4]; the L1 averages over
    max(positives, 1), mmdet3d over positives + 1e-4;
  * the decode applies no `post_center_limit_range`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

REG_BRANCHES = ("reg", "height", "dim", "rot", "vel")  # 2 + 1 + 3 + 2 + 2 = 10


def gaussian_radius(dx: torch.Tensor, dy: torch.Tensor, overlap: float) -> torch.Tensor:
    """CornerNet's radius (mmdet3d's gaussian_radius) of boxes dx x dy cells."""
    one = torch.ones((), device=dx.device)
    b1 = dx + dy
    c1 = dx * dy * (1 - overlap) / (one + overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 * b1 - 4 * c1, min=0.0))) / 2
    b2 = 2 * (dx + dy)
    c2 = (1 - overlap) * dx * dy
    r2 = (b2 + torch.sqrt(torch.clamp(b2 * b2 - 16 * c2, min=0.0))) / 2
    a3 = 4 * overlap
    b3 = -2 * overlap * (dx + dy)
    c3 = (overlap - 1) * dx * dy
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def targets(gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_mask: torch.Tensor,
            gt_vel: torch.Tensor, tasks: Sequence[Sequence[str]], feat: Tuple[int, int],
            head: Dict) -> List[Dict[str, torch.Tensor]]:
    """Per task {heatmap [B, H, W, C_t], anno [B, M, 10], pos [B, M], mask [B, M]}."""
    h, w = feat
    dev = gt_boxes.device
    pcr, vs, stride = head["point_cloud_range"], head["voxel_size"], head["out_factor"]
    cell_x = torch.tensor(vs[0] * stride, device=dev)
    cell_y = torch.tensor(vs[1] * stride, device=dev)
    cx = (gt_boxes[..., 0] - pcr[0]) / cell_x
    cy = (gt_boxes[..., 1] - pcr[1]) / cell_y
    inside = gt_mask & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    radius = gaussian_radius(gt_boxes[..., 3] / cell_x, gt_boxes[..., 4] / cell_y,
                             head["gaussian_overlap"]).floor().clamp(min=head["min_radius"])
    sigma = radius.clamp(min=1.0) / torch.tensor(3.0, device=dev)
    task_of, idx_in = [], []
    for t, names in enumerate(tasks):
        task_of += [t] * len(names)
        idx_in += list(range(len(names)))
    label = gt_labels.long().clamp(0, len(task_of) - 1)
    task_of = torch.tensor(task_of, device=dev)[label]
    idx_in = torch.tensor(idx_in, device=dev)[label]
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    m = head["max_objs"]
    out = []
    for t, names in enumerate(tasks):
        mine = inside & (task_of == t)
        # the task's boxes first, in their order; then the rest, masked out
        order = torch.sort((~mine).to(torch.uint8), dim=1, stable=True).indices[:, :m]

        def take(x):
            return torch.gather(x, 1, order.reshape(order.shape + (1,) * (x.dim() - 2)).expand(
                order.shape + x.shape[2:]))

        valid, bx, by = take(mine), take(cx), take(cy)
        ix = bx.to(torch.int32).clamp(0, w - 1)
        iy = by.to(torch.int32).clamp(0, h - 1)
        box = take(gt_boxes)
        anno = torch.cat([(bx - ix)[..., None], (by - iy)[..., None], box[..., 2:3],
                          torch.log(box[..., 3:6].clamp(min=1e-3)), torch.sin(box[..., 6:7]),
                          torch.cos(box[..., 6:7]), take(gt_vel)], -1)
        # every box's gaussian over the whole grid, then the class maps' maximum
        s = take(sigma)
        g = torch.exp(-((xs[None, None] - bx[..., None, None]) ** 2
                        + (ys[None, None] - by[..., None, None]) ** 2)
                      / (2 * s[..., None, None] ** 2))  # [B, M, H, W]
        g = torch.where((g >= math.exp(-4.5)) & valid[..., None, None], g, torch.zeros_like(g))
        # another task's boxes (masked out) may hold any index
        cls = F.one_hot(take(idx_in).clamp(max=len(names) - 1), len(names)).to(torch.bool)
        hm = torch.where(cls[:, :, None, None, :], g[..., None], torch.zeros_like(g[..., None]))
        hm = hm.amax(1) if hm.shape[1] else hm.new_zeros(hm.shape[:1] + hm.shape[2:])
        pos = iy * w + ix
        peak = F.one_hot(pos.long(), h * w).to(torch.bool)[..., None] & cls[:, :, None, :]
        peak = (peak & valid[..., None, None]).any(1).reshape(hm.shape)
        hm = torch.where(peak, torch.ones_like(hm), hm)
        out.append({"heatmap": hm, "anno": anno, "pos": pos, "mask": valid})
    return out


def reg_map(pred: Dict[str, torch.Tensor]) -> torch.Tensor:
    b, h, w = pred["heatmap"].shape[:3]
    return torch.cat([pred[k] for k in REG_BRANCHES], -1).reshape(b, h * w, 10)


def focal_loss(logits: torch.Tensor, target: torch.Tensor, avg: torch.Tensor,
               alpha: float = 2.0, gamma: float = 4.0) -> torch.Tensor:
    """GaussianFocalLoss on sigmoid(logits), its logs as softplus."""
    p = torch.sigmoid(logits)
    pos = (target == 1.0).float()
    pos_loss = F.softplus(-logits) * (1 - p) ** alpha * pos
    neg_loss = F.softplus(logits) * p ** alpha * (1 - target) ** gamma * (1 - pos)
    return (pos_loss.sum() + neg_loss.sum()) / avg


def loss(preds: Sequence[Dict[str, torch.Tensor]], tgts: Sequence[Dict[str, torch.Tensor]],
         head: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(heatmap loss, bbox loss), each weighted and summed over the tasks."""
    h, w = preds[0]["heatmap"].shape[1:3]
    cw = torch.tensor(head["code_weights"], device=preds[0]["heatmap"].device)
    l_hm = l_bbox = torch.zeros((), device=cw.device)
    for pred, tgt in zip(preds, tgts):
        mask = tgt["mask"].float()
        n = mask.sum().clamp(min=1.0)
        l_hm = l_hm + head["heatmap_weight"] * focal_loss(pred["heatmap"].float(),
                                                          tgt["heatmap"], n)
        pos = tgt["pos"].long().clamp(0, h * w - 1)
        rows = torch.gather(reg_map(pred), 1, pos[..., None].expand(*pos.shape, 10))
        diff = torch.nan_to_num((rows - tgt["anno"]).abs() * cw, nan=0.0, posinf=0.0,
                                neginf=0.0)
        l_bbox = l_bbox + head["bbox_weight"] * (diff * mask[..., None]).sum() / n
    return l_hm, l_bbox


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def circle_nms(centers: torch.Tensor, valid: torch.Tensor, min_radius: torch.Tensor
               ) -> torch.Tensor:
    """mmdet3d's circle_nms over rows [..., N] in descending score order:
    candidate i is kept when valid and no kept j < i lies at a squared
    distance <= the row's min_radius [...]."""
    d2 = ((centers[..., :, None, :] - centers[..., None, :, :]) ** 2).sum(-1)
    near = d2 <= min_radius[..., None, None]
    keep = torch.zeros_like(valid)
    for i in range(valid.shape[-1]):
        hit = (keep[..., :i] & near[..., :i, i]).any(-1)
        keep[..., i] = valid[..., i] & ~hit
    return keep


def decode(preds: Sequence[Dict[str, torch.Tensor]], tasks: Sequence[Sequence[str]],
           head: Dict) -> Tuple[torch.Tensor, ...]:
    """(boxes [B, K, 9] as (x, y, z, dx, dy, dz, yaw, vx, vy), scores,
    labels int32, valid)."""
    pcr, vs, stride = head["point_cloud_range"], head["voxel_size"], head["out_factor"]
    b, h, w = preds[0]["heatmap"].shape[:3]
    first = 0
    cands = []
    for pred in preds:
        c = pred["heatmap"].shape[-1]
        scores, flat = top_k(torch.sigmoid(pred["heatmap"]).reshape(b, h * w * c),
                             min(head["nms_pre"], h * w * c))
        cell = flat // c
        label = (flat % c + first).to(torch.int32)
        first += c
        rows = torch.gather(reg_map(pred), 1, cell[..., None].expand(*cell.shape, 10))
        x = ((cell % w).to(torch.float32) + rows[..., 0]) * vs[0] * stride + pcr[0]
        y = ((cell // w).to(torch.float32) + rows[..., 1]) * vs[1] * stride + pcr[1]
        boxes = torch.cat([x[..., None], y[..., None], rows[..., 2:3],
                           torch.exp(rows[..., 3:6].clamp(-8.0, 8.0)),
                           torch.atan2(rows[..., 6], rows[..., 7])[..., None], rows[..., 8:10]],
                          -1)
        cands.append((boxes, scores, label))
    radii = torch.tensor([float(r) for r in head["circle_radius"]], device=cands[0][1].device)
    out = ([], [], [], [])
    for t, (boxes, scores, label) in enumerate(cands):
        keep = circle_nms(boxes[..., :2], scores > head["score_thr"], radii[t].expand(b))
        top, sel = top_k(torch.where(keep, scores, torch.full_like(scores, -1.0)),
                         min(head["max_per_task"], scores.shape[-1]))
        out[0].append(torch.gather(boxes, 1, sel[..., None].expand(*sel.shape, 9)))
        out[1].append(top)
        out[2].append(torch.gather(label, 1, sel))
        out[3].append(top > 0.0)
    return tuple(torch.cat(o, 1) for o in out)
