"""Box geometry: rotated BEV IoU by polygon clipping (float32 throughout).

Counterpart of robustpointclouds_tpu/ops/boxes.py (box_bev_corners,
rotated_bev_iou and its clipping helpers, boxes3d_to_bev, box3d_corners,
rotated_iou_3d (the KITTI metric's 3D IoU), limit_period, and
the assigner's nearest_bev_boxes / aligned_bev_iou / nearest_bev_iou, which
keep the JAX op order so the assignment is bit-equal).
The JAX version vmaps a per-pair function; here every helper broadcasts over
leading dimensions instead, so one call covers [..., N, M] pair grids
(batch x class x pre-NMS boxes in ops/nms.py).

Box conventions: 7-DoF (x, y, z, dx, dy, dz, yaw) with z the gravity centre;
BEV (x, y, dx, dy, yaw).
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-8


def box_bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (x, y, dx, dy, yaw) -> [..., 4, 2] corners, counter-clockwise."""
    x, y, dx, dy, yaw = boxes.unbind(-1)
    hx, hy = dx * 0.5, dy * 0.5
    c, s = torch.cos(yaw), torch.sin(yaw)
    corners = [
        torch.stack([x + lx * c - ly * s, y + lx * s + ly * c], dim=-1)
        for lx, ly in ((hx, hy), (-hx, hy), (-hx, -hy), (hx, -hy))
    ]
    return torch.stack(corners, dim=-2)


def _segment_intersections(ca: torch.Tensor, cb: torch.Tensor):
    """All 16 edge-pair intersections of two quads [..., 4, 2].

    Returns pts [..., 16, 2] and valid [..., 16] (A's edge i pairs with B's
    edge j at slot 4*i + j, as in the JAX version).
    """
    a0 = ca.repeat_interleave(4, dim=-2)
    a1 = torch.roll(ca, -1, dims=-2).repeat_interleave(4, dim=-2)
    b0 = torch.cat([cb] * 4, dim=-2)
    b1 = torch.cat([torch.roll(cb, -1, dims=-2)] * 4, dim=-2)
    r = a1 - a0
    s = b1 - b0
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = b0 - a0
    safe = torch.where(denom.abs() < _EPS, torch.ones_like(denom), denom)
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / safe
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / safe
    valid = (denom.abs() >= _EPS) & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    return a0 + t[..., None] * r, valid


def _points_in_quad(pts: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """Point-in-convex-quad (CCW). pts [..., K, 2], quad [..., 4, 2] -> [..., K]."""
    e0 = quad[..., None, :, :]
    e1 = torch.roll(quad, -1, dims=-2)[..., None, :, :]
    p = pts[..., :, None, :]
    d = (e1[..., 0] - e0[..., 0]) * (p[..., 1] - e0[..., 1]) - (
        e1[..., 1] - e0[..., 1]
    ) * (p[..., 0] - e0[..., 0])
    return torch.all(d >= -1e-6, dim=-1)


def _poly_area_sorted(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Area of the convex polygon spanned by the valid candidate vertices.

    Sorts valid points by angle around their centroid (stable, invalid last)
    and applies the shoelace formula. pts [..., K, 2], valid [..., K].
    """
    k = pts.shape[-2]
    nvalid = valid.sum(-1)
    safe_n = torch.clamp(nvalid, min=1).to(pts.dtype)
    vpts = torch.where(valid[..., None], pts, torch.zeros_like(pts))
    centroid = vpts.sum(-2) / safe_n[..., None]
    ang = torch.atan2(pts[..., 1] - centroid[..., None, 1], pts[..., 0] - centroid[..., None, 0])
    ang = torch.where(valid, ang, torch.full_like(ang, math.inf))
    order = torch.argsort(ang, dim=-1, stable=True)
    sp = torch.gather(pts, -2, order[..., None].expand(pts.shape))
    idx = torch.arange(k, device=pts.device)
    nxt = torch.where(idx == (nvalid[..., None] - 1), torch.zeros_like(idx), idx + 1)
    nxt = torch.clamp(nxt, 0, k - 1)
    p1 = torch.gather(sp, -2, nxt[..., None].expand(sp.shape))
    contrib = sp[..., 0] * p1[..., 1] - p1[..., 0] * sp[..., 1]
    contrib = torch.where(idx < nvalid[..., None], contrib, torch.zeros_like(contrib))
    area = 0.5 * contrib.sum(-1).abs()
    return torch.where(nvalid >= 3, area, torch.zeros_like(area))


def rotated_bev_overlap(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated-BEV intersection areas: [..., N, 5] x [..., M, 5] -> [..., N, M]."""
    ca = box_bev_corners(boxes_a)[..., :, None, :, :]  # [..., N, 1, 4, 2]
    cb = box_bev_corners(boxes_b)[..., None, :, :, :]  # [..., 1, M, 4, 2]
    ca, cb = torch.broadcast_tensors(ca, cb)
    inter_pts, inter_valid = _segment_intersections(ca, cb)
    a_in_b = _points_in_quad(ca, cb)
    b_in_a = _points_in_quad(cb, ca)
    pts = torch.cat([inter_pts, ca, cb], dim=-2)  # [..., N, M, 24, 2]
    valid = torch.cat([inter_valid, a_in_b, b_in_a], dim=-1)
    return _poly_area_sorted(pts, valid)


def rotated_bev_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated-BEV IoU, [..., N, 5] x [..., M, 5] -> [..., N, M].

    Degenerate boxes (non-positive extent) get IoU 0.
    """
    inter = rotated_bev_overlap(boxes_a, boxes_b)
    area_a = (boxes_a[..., 2] * boxes_a[..., 3])[..., :, None]
    area_b = (boxes_b[..., 2] * boxes_b[..., 3])[..., None, :]
    iou = inter / torch.clamp(area_a + area_b - inter, min=_EPS)
    nondegenerate = (area_a > _EPS) & (area_b > _EPS)
    return torch.where(nondegenerate, iou, torch.zeros_like(iou))


def boxes3d_to_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] -> [..., 5] BEV box (x, y, dx, dy, yaw). Slices, not a list
    index: on the card a list index is a host-to-device copy that waits for
    the card."""
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]], -1)


def box3d_corners(boxes: torch.Tensor) -> torch.Tensor:
    """8 corners of 7-DoF boxes: [..., 7] -> [..., 8, 3], bottom 4 then top 4."""
    bev = box_bev_corners(boxes3d_to_bev(boxes))  # [..., 4, 2]
    z, dz = boxes[..., 2:3], boxes[..., 5:6]
    zb = (z - dz * 0.5)[..., None, :].expand(*bev.shape[:-1], 1)
    zt = (z + dz * 0.5)[..., None, :].expand(*bev.shape[:-1], 1)
    return torch.cat([torch.cat([bev, zb], -1), torch.cat([bev, zt], -1)], dim=-2)


def rotated_iou_3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise 3D IoU of 7-DoF boxes (rotated BEV overlap x z-overlap):
    [..., N, 7] x [..., M, 7] -> [..., N, M]."""
    inter_bev = rotated_bev_overlap(boxes3d_to_bev(boxes_a), boxes3d_to_bev(boxes_b))
    za_lo = boxes_a[..., 2] - boxes_a[..., 5] * 0.5
    za_hi = boxes_a[..., 2] + boxes_a[..., 5] * 0.5
    zb_lo = boxes_b[..., 2] - boxes_b[..., 5] * 0.5
    zb_hi = boxes_b[..., 2] + boxes_b[..., 5] * 0.5
    z_overlap = torch.clamp(
        torch.minimum(za_hi[..., :, None], zb_hi[..., None, :])
        - torch.maximum(za_lo[..., :, None], zb_lo[..., None, :]), min=0.0)
    inter = inter_bev * z_overlap
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return inter / torch.clamp(vol_a + vol_b - inter, min=_EPS)


def nearest_bev_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """Rotation-snapped axis-aligned BEV boxes [..., 4] = (x1, y1, x2, y2) from
    [..., 7] or [..., 5] BEV boxes (mmdet3d BboxOverlapsNearest3D): yaw snaps
    to the nearest axis; the extents swap when the box is closer to vertical."""
    if boxes.shape[-1] == 7:
        boxes = boxes3d_to_bev(boxes)
    x, y, dx, dy, yaw = boxes.unbind(-1)
    rot = torch.abs(torch.remainder(yaw, math.pi))
    swap = (rot > math.pi / 4) & (rot < 3 * math.pi / 4)
    ex = torch.where(swap, dy, dx) * 0.5
    ey = torch.where(swap, dx, dy) * 0.5
    return torch.stack([x - ex, y - ey, x + ex, y + ey], dim=-1)


def aligned_bev_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of axis-aligned boxes: [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (boxes_a[..., 2] - boxes_a[..., 0]) * (boxes_a[..., 3] - boxes_a[..., 1])
    area_b = (boxes_b[..., 2] - boxes_b[..., 0]) * (boxes_b[..., 3] - boxes_b[..., 1])
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :] - inter, min=_EPS)


def nearest_bev_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """BboxOverlapsNearest3D IoU of 7-DoF boxes: [..., N, 7] x [..., M, 7] -> [..., N, M]."""
    return aligned_bev_iou(nearest_bev_boxes(boxes_a), nearest_bev_boxes(boxes_b))


def limit_period(val: torch.Tensor, offset: float = 0.5, period: float = math.pi) -> torch.Tensor:
    """Limit angles into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period
