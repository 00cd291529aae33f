"""Host-side point-cloud transforms (a copy of the part of robustpointclouds_tpu/data/transforms.py that evaluation uses).

Samples are plain dicts: {'points' [N, 4], 'gt_boxes' [G, 7], 'gt_labels'
[G], ...}. The training augmentations (ObjectNoise, RandomFlip3D,
GlobalRotScaleTrans, GT-paste) are not ported yet (ROADMAP.md, M7).
"""
from __future__ import annotations

from typing import Dict, Sequence


def filter_range(sample: Dict, pcr: Sequence[float]) -> Dict:
    """PointsRangeFilter + ObjectRangeFilter (on box centers, BEV)."""
    points = sample["points"]
    pm = (
        (points[:, 0] >= pcr[0]) & (points[:, 0] < pcr[3])
        & (points[:, 1] >= pcr[1]) & (points[:, 1] < pcr[4])
        & (points[:, 2] >= pcr[2]) & (points[:, 2] < pcr[5])
    )
    boxes = sample["gt_boxes"]
    out = dict(sample)
    out["points"] = points[pm]
    if len(boxes):
        bm = (
            (boxes[:, 0] >= pcr[0]) & (boxes[:, 0] < pcr[3])
            & (boxes[:, 1] >= pcr[1]) & (boxes[:, 1] < pcr[4])
        )
        out["gt_boxes"] = boxes[bm]
        out["gt_labels"] = sample["gt_labels"][bm]
        for k in ("gt_difficulty", "gt_bbox2d", "gt_alpha"):
            if k in sample and len(sample[k]) == len(bm):
                out[k] = sample[k][bm]
    return out
