"""Host-side point-cloud augmentation, numpy only (counterpart of robustpointclouds_tpu/data/transforms.py).

The reference train pipeline's geometric transforms: ObjectNoise (per-object
jitter with collision-free retries), RandomFlip3D, GlobalRotScaleTrans, the
Points/Object range filters and PointShuffle, plus GT-paste (ObjectSample /
db_sampler) through `GroundTruthDatabase`, collected on the fly from the
train split or pre-seeded from an mmdet3d `kitti_dbinfos_train.pkl`. Every
draw comes from the caller's `np.random.RandomState`, in the JAX package's
order, so the same seed gives the same sample.

Samples are plain dicts: {'points' [N, 4], 'gt_boxes' [G, 7], 'gt_labels' [G], ...}.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def points_in_box(points: np.ndarray, box: np.ndarray, margin: float = 0.0) -> np.ndarray:
    """Mask of points inside a 7-DoF box (center-z convention)."""
    d = points[:, :3] - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    local_x = d[:, 0] * c - d[:, 1] * s
    local_y = d[:, 0] * s + d[:, 1] * c
    return (
        (np.abs(local_x) <= box[3] / 2 + margin)
        & (np.abs(local_y) <= box[4] / 2 + margin)
        & (np.abs(d[:, 2]) <= box[5] / 2 + margin)
    )


def _bev_collides(box: np.ndarray, others: np.ndarray) -> bool:
    """Cheap axis-aligned BEV overlap test against a set of boxes."""
    if len(others) == 0:
        return False
    r = np.hypot(box[3], box[4]) / 2
    ro = np.hypot(others[:, 3], others[:, 4]) / 2
    d = np.hypot(others[:, 0] - box[0], others[:, 1] - box[1])
    return bool(np.any(d < (r + ro)))


def object_noise(
    sample: Dict,
    rng: np.random.RandomState,
    translation_std: Sequence[float] = (1.0, 1.0, 0.5),
    rot_range: Sequence[float] = (-0.78539816, 0.78539816),
    num_try: int = 100,
) -> Dict:
    """Per-object random translate+rotate, moving the object's points with it
    and rejecting placements that collide with other boxes."""
    points = sample["points"].copy()
    boxes = sample["gt_boxes"].copy()
    for i in range(len(boxes)):
        mask = points_in_box(points, boxes[i])
        others = np.delete(boxes, i, axis=0)
        for _ in range(num_try):
            t = rng.normal(0, translation_std, 3).astype(np.float32)
            r = rng.uniform(*rot_range)
            new_box = boxes[i].copy()
            new_box[:3] += t
            new_box[6] += r
            if _bev_collides(new_box, others):
                continue
            pts = points[mask].copy()
            local = pts[:, :3] - boxes[i][:3]
            local = local @ _rot_z(r).T
            pts[:, :3] = local + new_box[:3]
            points[mask] = pts
            boxes[i] = new_box
            break
    out = dict(sample)
    out["points"], out["gt_boxes"] = points, boxes
    return out


def random_flip(sample: Dict, rng: np.random.RandomState, prob: float = 0.5) -> Dict:
    """BEV horizontal flip (y -> -y), reference RandomFlip3D."""
    if rng.rand() >= prob:
        return sample
    points = sample["points"].copy()
    boxes = sample["gt_boxes"].copy()
    points[:, 1] *= -1
    if len(boxes):
        boxes[:, 1] *= -1
        boxes[:, 6] = -boxes[:, 6]
    out = dict(sample)
    out["points"], out["gt_boxes"] = points, boxes
    return out


def global_rot_scale_trans(
    sample: Dict,
    rng: np.random.RandomState,
    rot_range: Sequence[float] = (-0.78539816, 0.78539816),
    scale_range: Sequence[float] = (0.95, 1.05),
    translation_std: Sequence[float] = (0.0, 0.0, 0.0),
) -> Dict:
    points = sample["points"].copy()
    boxes = sample["gt_boxes"].copy()
    theta = rng.uniform(*rot_range)
    scale = rng.uniform(*scale_range)
    t = rng.normal(0, translation_std, 3).astype(np.float32)
    R = _rot_z(theta)
    points[:, :3] = points[:, :3] @ R.T * scale + t
    if len(boxes):
        boxes[:, :3] = boxes[:, :3] @ R.T * scale + t
        boxes[:, 3:6] *= scale
        boxes[:, 6] += theta
    out = dict(sample)
    out["points"], out["gt_boxes"] = points, boxes
    return out


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


def shuffle_points(sample: Dict, rng: np.random.RandomState) -> Dict:
    out = dict(sample)
    out["points"] = sample["points"][rng.permutation(len(sample["points"]))]
    return out


class GroundTruthDatabase:
    """On-the-fly GT-paste database (ObjectSample / db_sampler equivalent).

    Collects (box, points-inside) crops per class from seen samples and pastes
    them into later scenes up to per-class targets, rejecting BEV collisions —
    the reference's `sample_groups=dict(Car=15)` semantics
    (configs/_base_/kitti-3d-car.py:27-40) without the offline dbinfos pickle.
    """

    def __init__(
        self,
        sample_groups: Optional[Dict[int, int]] = None,
        min_points: int = 5,
        max_per_class: int = 2000,
    ):
        self.sample_groups = sample_groups or {0: 15, 1: 10, 2: 10}
        self.min_points = min_points
        self.max_per_class = max_per_class
        self._db: Dict[int, List] = {c: [] for c in self.sample_groups}

    @classmethod
    def from_dbinfos(
        cls,
        path: str,
        data_root: str,
        classes: Sequence[str] = ("Car", "Pedestrian", "Cyclist"),
        sample_groups: Optional[Dict[int, int]] = None,
        min_points: int = 5,
        max_per_class: int = 2000,
    ) -> "GroundTruthDatabase":
        """Pre-seed the database from an mmdet3d `kitti_dbinfos_train.pkl`
        (the reference's offline db_sampler input,
        configs/_base_/kitti-3d-car.py:27-33: `info_path=...kitti_dbinfos_
        train.pkl`, `filter_by_min_points`).

        dbinfos crops store points RELATIVE to the box bottom-center and
        boxes in mmdet3d's bottom-z convention; both are converted to this
        framework's absolute-points / center-z layout on load. On-the-fly
        collection stays active on top.
        """
        import pickle

        db = cls(sample_groups=sample_groups, min_points=min_points,
                 max_per_class=max_per_class)
        with open(path, "rb") as f:
            infos = pickle.load(f)
        cls_to_id = {c: i for i, c in enumerate(classes)}
        for name, entries in infos.items():
            label = cls_to_id.get(name)
            if label is None or label not in db._db:
                continue
            for info in entries:
                if len(db._db[label]) >= max_per_class:
                    break
                if int(info.get("num_points_in_gt", min_points)) < min_points:
                    continue
                box = np.asarray(info["box3d_lidar"], np.float32).copy()
                bin_path = os.path.join(data_root, info["path"])
                if not os.path.isfile(bin_path):
                    continue
                pts = np.fromfile(bin_path, np.float32).reshape(-1, 4).copy()
                pts[:, :3] += box[:3]  # crop coords are box-relative
                box[2] += box[5] / 2.0  # bottom z -> center z
                if len(pts) >= min_points:
                    db._db[label].append((box, pts))
        return db

    def collect(self, sample: Dict):
        for box, label in zip(sample["gt_boxes"], sample["gt_labels"]):
            if label not in self._db or len(self._db[label]) >= self.max_per_class:
                continue
            pts = sample["points"][points_in_box(sample["points"], box)]
            if len(pts) >= self.min_points:
                self._db[label].append((box.copy(), pts.copy()))

    def paste(self, sample: Dict, rng: np.random.RandomState) -> Dict:
        boxes = list(sample["gt_boxes"])
        labels = list(sample["gt_labels"])
        diffs = list(sample.get("gt_difficulty", np.zeros(len(boxes), np.int32)))
        extra_points = []
        for cls, target in self.sample_groups.items():
            pool = self._db.get(cls, [])
            have = sum(1 for l in labels if l == cls)
            need = max(0, target - have)
            if not pool or need == 0:
                continue
            for k in rng.choice(len(pool), min(need, len(pool)), replace=False):
                box, pts = pool[k]
                if _bev_collides(box, np.asarray(boxes).reshape(-1, 7)):
                    continue
                boxes.append(box)
                labels.append(cls)
                diffs.append(0)
                extra_points.append(pts)
        out = dict(sample)
        if extra_points:
            # remove background points inside pasted boxes, then add crops
            points = sample["points"]
            for box in boxes[len(sample["gt_boxes"]):]:
                points = points[~points_in_box(points, box)]
            out["points"] = np.concatenate([points] + extra_points, axis=0)
            out["gt_boxes"] = np.asarray(boxes, np.float32).reshape(-1, 7)
            out["gt_labels"] = np.asarray(labels, np.int32)
            out["gt_difficulty"] = np.asarray(diffs, np.int32)
        return out


def augment_sample(
    sample: Dict,
    rng: np.random.RandomState,
    pcr: Sequence[float],
    gt_db: Optional[GroundTruthDatabase] = None,
) -> Dict:
    """The reference train pipeline order (configs/_base_/kitti-3d-car.py:42-68):
    [ObjectSample] -> ObjectNoise -> RandomFlip3D -> GlobalRotScaleTrans ->
    range filters -> PointShuffle."""
    if gt_db is not None:
        gt_db.collect(sample)
        sample = gt_db.paste(sample, rng)
    sample = object_noise(sample, rng)
    sample = random_flip(sample, rng)
    sample = global_rot_scale_trans(sample, rng)
    sample = filter_range(sample, pcr)
    sample = shuffle_points(sample, rng)
    return sample
