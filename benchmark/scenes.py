"""The one generator of the benchmark's traffic: synthetic LiDAR scenes made
from a traffic file's parameters and the run's seed (numpy only).

A frame holds `objects` boxes of the traffic's classes (sizes jittered by
+-10%, centres inset from the range's edge, yaw uniform, a velocity in the
plane), `foreground_share` of its points uniform inside the boxes and the
rest on a noisy ground plane, intensity uniform in [0, 1). With `sweeps` >
1 each point comes from one of that many sweeps `sweep_interval_s` apart
(key frame first), its lag in the fifth feature, and an object's points
trail it by -velocity * lag; the ground does not move. After the copies of
the port's synthetic_kitti_batch and synthetic_nuscenes_batch, with the
points a frame and the sweeps as parameters. Every seed gives the same sizes
(points, objects, boxes a frame), only other values.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def frame_batch(rng: np.random.Generator, t: Dict) -> Dict[str, np.ndarray]:
    """One batch of `t["batch"]` frames: points [B, P, F] float32, points_mask
    [B, P], gt_boxes [B, G, 7], gt_labels [B, G] int32, gt_mask [B, G],
    gt_vel [B, G, 2]."""
    b, p, g = int(t["batch"]), int(t["points_per_frame"]), int(t["max_gt"])
    n_obj = min(int(t["objects"]), g)
    nf = int(t["features"])
    lo = np.asarray(t["point_range"][:3], np.float32)
    hi = np.asarray(t["point_range"][3:], np.float32)
    sizes_tab = np.asarray(t["class_sizes"], np.float32)
    inset = float(t["center_inset"])
    zlo, zhi = t["object_z"]
    glo, gsd = t["ground_z"]
    vmax = float(t["velocity"])
    sweeps = int(t["sweeps"])
    dt = float(t["sweep_interval_s"])

    labels = rng.integers(0, len(sizes_tab), (b, n_obj))
    sizes = sizes_tab[labels] * rng.uniform(0.9, 1.1, (b, n_obj, 3)).astype(np.float32)
    centers = np.stack([rng.uniform(lo[0] + inset, hi[0] - inset, (b, n_obj)),
                        rng.uniform(lo[1] + inset, hi[1] - inset, (b, n_obj)),
                        rng.uniform(zlo, zhi, (b, n_obj))], -1).astype(np.float32)
    yaws = rng.uniform(-np.pi, np.pi, (b, n_obj)).astype(np.float32)
    vel = rng.uniform(-vmax, vmax, (b, n_obj, 2)).astype(np.float32)

    per = int(p * float(t["foreground_share"])) // n_obj
    n_fg = per * n_obj
    local = rng.uniform(-0.5, 0.5, (b, n_obj, per, 3)).astype(np.float32) * sizes[:, :, None]
    c, s = np.cos(yaws)[..., None], np.sin(yaws)[..., None]
    fg = np.empty_like(local)
    fg[..., 0] = local[..., 0] * c - local[..., 1] * s
    fg[..., 1] = local[..., 0] * s + local[..., 1] * c
    fg[..., 2] = local[..., 2]
    fg += centers[:, :, None]
    lag = (rng.integers(0, sweeps, (b, p)) * dt).astype(np.float32)
    fg_lag = lag[:, :n_fg].reshape(b, n_obj, per)
    fg[..., :2] -= vel[:, :, None, :] * fg_lag[..., None]

    n_bg = p - n_fg
    bg = np.stack([rng.uniform(lo[0], hi[0], (b, n_bg)), rng.uniform(lo[1], hi[1], (b, n_bg)),
                   rng.normal(glo, gsd, (b, n_bg))], -1).astype(np.float32)
    points = np.zeros((b, p, nf), np.float32)
    points[:, :n_fg, :3] = fg.reshape(b, n_fg, 3)
    points[:, n_fg:, :3] = bg
    points[:, :, 3] = rng.random((b, p), dtype=np.float32)
    if nf > 4:
        points[:, :, 4] = lag

    gt_boxes = np.zeros((b, g, 7), np.float32)
    gt_boxes[:, :n_obj, :3] = centers
    gt_boxes[:, :n_obj, 3:6] = sizes
    gt_boxes[:, :n_obj, 6] = yaws
    gt_labels = np.zeros((b, g), np.int32)
    gt_labels[:, :n_obj] = labels
    gt_mask = np.zeros((b, g), bool)
    gt_mask[:, :n_obj] = True
    gt_vel = np.zeros((b, g, 2), np.float32)
    gt_vel[:, :n_obj] = vel
    return {"points": points, "points_mask": np.ones((b, p), bool), "gt_boxes": gt_boxes,
            "gt_labels": gt_labels, "gt_mask": gt_mask, "gt_vel": gt_vel}


def pool(seed: int, t: Dict) -> List[Dict[str, np.ndarray]]:
    """The traffic's `pool` distinct batches, drawn from `seed`."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x5CE7E5]))
    return [frame_batch(rng, t) for _ in range(int(t["pool"]))]
