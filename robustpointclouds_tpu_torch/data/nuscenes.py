"""NuScenes data: the info-pkl reader with multi-sweep aggregation, the train augmentation, the loaders and synthetic scenes (counterpart of robustpointclouds_tpu/data/nuscenes.py).

The reader takes the standard `nuscenes_infos_{train,val}.pkl` (mmdet3d v2
`data_list` / `lidar_sweeps` or v1 `infos` / `sweeps` schema), normalises
the reference's duplicated storage paths, and stacks the key frame with up
to `max_sweeps` sweeps brought into the key frame (mmdet3d
LoadPointsFromMultiSweeps): 5-feature points whose last channel is the
sweep's time lag (0 on the key frame). The sweeps load through the port's
native library (data/native.load_sweeps, threaded) or, with
`use_native=False`, through numpy; either way the batches are the JAX
package's, bit for bit, from the same seed. Loaders yield numpy
(PointCloudBatch, gt_vel [B, G, 2]) pairs, the validation loader with the
per-row metas (pad rows of the last short batch are not scored).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from ..eval.nuscenes_metric import ATTR_NONE, ATTRIBUTES, _ATTR_TO_ID
from ..nn.center_head import NUSCENES_TASKS
from .synthetic import PointCloudBatch

NUSCENES_CLASSES = tuple(c for t in NUSCENES_TASKS for c in t)
_CLS_TO_ID = {c: i for i, c in enumerate(NUSCENES_CLASSES)}

_CLASS_SIZES = {
    "car": (4.6, 1.95, 1.7), "truck": (6.9, 2.5, 2.8),
    "construction_vehicle": (6.4, 2.7, 3.2), "bus": (11.0, 2.9, 3.5),
    "trailer": (12.3, 2.9, 3.9), "barrier": (0.5, 2.5, 1.0),
    "motorcycle": (2.1, 0.8, 1.5), "bicycle": (1.7, 0.6, 1.3),
    "pedestrian": (0.7, 0.7, 1.8), "traffic_cone": (0.4, 0.4, 1.1),
}


def nuscenes_available(data_root: str) -> bool:
    return any(
        os.path.isfile(os.path.join(data_root, f))
        for f in ("nuscenes_infos_train.pkl", "nuscenes_infos_val.pkl")
    )


def _normalize_path(data_root: str, lidar_path: str) -> str:
    """Fix the path duplication patterns the reference patches at runtime
    (data/nuscenes/data/nuscenes nesting, doubled samples/LIDAR_TOP,
    backslashes — train_nuscenes_adversarial.py:41-77)."""
    p = lidar_path.replace("\\", "/")
    dup = "data/nuscenes/data/nuscenes"
    while dup in p:
        p = p.replace(dup, "data/nuscenes")
    p = p.replace("samples/LIDAR_TOP/samples/LIDAR_TOP", "samples/LIDAR_TOP")
    if not os.path.isabs(p):
        if p.startswith("data/nuscenes/"):
            p = os.path.join(data_root, p[len("data/nuscenes/"):])
        else:
            p = os.path.join(data_root, p)
    return p


def _read_lidar(path: str) -> np.ndarray:
    """NuScenes LIDAR_TOP .bin: rows of (x, y, z, intensity, ring) — ring is
    replaced by the sweep-lag timestamp channel downstream."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 5)


class NuScenesDataset:
    """Info-pkl backed dataset yielding 5D points + 9D boxes (with velocity).

    Multi-sweep aggregation follows mmdet3d's LoadPointsFromMultiSweeps (the
    base CenterPoint config consumes 9 sweeps; the 5th point channel is the
    time lag of the sweep relative to the key frame, and the key frame's lag
    is 0 — reference base config via
    configs/adversarial/adversarial-centerpoint_voxel-nuscenes.py:11-13).
    Supports both the mmdet3d v2 info schema ('data_list' + 'lidar_sweeps')
    and the v1 schema ('infos' + 'sweeps' with sensor2lidar_{rotation,
    translation}).
    """

    def __init__(self, data_root: str, split: str = "train", max_sweeps: int = 9,
                 use_native: bool = True):
        self.data_root = data_root
        self.max_sweeps = max_sweeps
        self.use_native = use_native
        info_path = os.path.join(data_root, f"nuscenes_infos_{split}.pkl")
        with open(info_path, "rb") as f:
            data = pickle.load(f)
        self.infos = data["data_list"] if isinstance(data, dict) and "data_list" in data else (
            data["infos"] if isinstance(data, dict) else data
        )

    def __len__(self):
        return len(self.infos)

    def _sweep_specs(self, info, key_ts: float) -> list:
        """(path, [3,4] R|T or None, lag) per usable sweep."""
        specs = []
        sweeps = info.get("sweeps") or info.get("lidar_sweeps") or []
        for sw in sweeps[: self.max_sweeps]:
            lid = sw.get("lidar_points", sw)
            sw_path = lid.get("lidar_path", sw.get("data_path"))
            if not sw_path:
                continue
            path = _normalize_path(self.data_root, sw_path)
            if not os.path.isfile(path):
                continue
            # v1 schema: sensor2lidar rotation/translation on the sweep
            R = sw.get("sensor2lidar_rotation", lid.get("sensor2lidar_rotation"))
            T = sw.get("sensor2lidar_translation", lid.get("sensor2lidar_translation"))
            rt = None
            if R is not None and T is not None:
                rt = np.concatenate(
                    [np.asarray(R, np.float32).reshape(3, 3),
                     np.asarray(T, np.float32).reshape(3, 1)], axis=1,
                )
            ts = float(sw.get("timestamp", lid.get("timestamp", key_ts))) / 1e6
            specs.append((path, rt, max(key_ts / 1e6 - ts, 0.0)))
        return specs

    def _load_sweeps(self, info, key_ts: float) -> list:
        specs = self._sweep_specs(info, key_ts)
        if not specs:
            return []
        if self.use_native:
            # threaded native load + transform (csrc rpc_load_sweeps)
            from . import native

            return native.load_sweeps(
                [s[0] for s in specs], [s[1] for s in specs],
                [s[2] for s in specs],
            )
        out = []
        for path, rt, lag in specs:
            pts = _read_lidar(path)
            if rt is not None:
                pts = pts.copy()
                pts[:, :3] = (
                    pts[:, :3].astype(np.float64) @ rt[:, :3].T.astype(np.float64)
                    + rt[:, 3].astype(np.float64)
                ).astype(np.float32)
            pts[:, 4] = lag
            out.append(pts)
        return out

    def get(self, idx: int) -> Dict:
        info = self.infos[idx]
        lidar = info.get("lidar_points", info)
        lidar_path = lidar.get("lidar_path", info.get("lidar_path"))
        path = _normalize_path(self.data_root, lidar_path)
        pts = _read_lidar(path)
        pts[:, 4] = 0.0  # key frame time lag
        key_ts = float(info.get("timestamp", lidar.get("timestamp", 0.0)))
        sweeps = self._load_sweeps(info, key_ts)
        if sweeps:
            pts = np.concatenate([pts] + sweeps, axis=0)
        # annotations: mmdet3d v2 'instances' or v1 'gt_boxes'/'gt_names'.
        # Attributes (the devkit's 5th TP metric, AAE) ride as 'attr_label'
        # ints in v2 instances (mmdet3d nuscenes_converter nus_attributes
        # order == eval.nuscenes_metric.ATTRIBUTES) or 'gt_attrs' name
        # strings in v1-style infos; absent -> the no-attribute sentinel.
        boxes, labels, vel, attrs = [], [], [], []
        if "instances" in info:
            for inst in info["instances"]:
                b = np.asarray(inst["bbox_3d"], np.float32)
                name_id = inst.get("bbox_label_3d", -1)
                if name_id < 0 or name_id >= len(NUSCENES_CLASSES):
                    continue
                # mmdet3d nus boxes: (x, y, z_bottom, dx, dy, dz, yaw[, vx, vy])
                center_z = b[2] + b[5] / 2.0
                boxes.append([b[0], b[1], center_z, b[3], b[4], b[5], b[6]])
                vel.append(b[7:9] if len(b) >= 9 else np.zeros(2, np.float32))
                labels.append(name_id)
                a = inst.get("attr_label", ATTR_NONE)
                attrs.append(a if 0 <= a < len(ATTRIBUTES) else ATTR_NONE)
        else:
            names = info.get("gt_names", [])
            gtb = np.asarray(info.get("gt_boxes", np.zeros((0, 7))), np.float32)
            gtv = np.asarray(info.get("gt_velocity", np.zeros((len(gtb), 2))), np.float32)
            gta = info.get("gt_attrs", [None] * len(gtb))
            for b, name, v, a in zip(gtb, names, gtv, gta):
                if name not in _CLS_TO_ID:
                    continue
                boxes.append([b[0], b[1], b[2] + b[5] / 2.0, b[3], b[4], b[5], b[6]])
                vel.append(np.nan_to_num(v))
                labels.append(_CLS_TO_ID[name])
                attrs.append(_ATTR_TO_ID.get(a, ATTR_NONE))
        return {
            "points": pts,
            "gt_boxes": np.asarray(boxes, np.float32).reshape(-1, 7),
            "gt_labels": np.asarray(labels, np.int32),
            "gt_vel": np.asarray(vel, np.float32).reshape(-1, 2),
            "gt_attrs": np.asarray(attrs, np.int32),
        }


def augment_nuscenes_sample(sample: Dict, rng: np.random.RandomState, pcr) -> Dict:
    """NuScenes train augmentation (reference base CenterPoint pipeline):
    RandomFlip3D (x and y) + GlobalRotScaleTrans + range filter, with the
    velocity vectors transformed alongside the boxes."""
    pts = sample["points"].copy()
    boxes = sample["gt_boxes"].copy()
    vel = sample["gt_vel"].copy()

    if rng.rand() < 0.5:  # flip y
        pts[:, 1] *= -1
        boxes[:, 1] *= -1
        boxes[:, 6] = -boxes[:, 6]
        vel[:, 1] *= -1
    if rng.rand() < 0.5:  # flip x
        pts[:, 0] *= -1
        boxes[:, 0] *= -1
        boxes[:, 6] = np.pi - boxes[:, 6]
        vel[:, 0] *= -1

    ang = rng.uniform(-np.pi / 4, np.pi / 4)
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -s], [s, c]], np.float32)
    pts[:, :2] = pts[:, :2] @ rot.T
    boxes[:, :2] = boxes[:, :2] @ rot.T
    boxes[:, 6] += ang
    vel = vel @ rot.T

    scale = rng.uniform(0.95, 1.05)
    pts[:, :3] *= scale
    boxes[:, :6] *= scale
    vel *= scale

    pm = (
        (pts[:, 0] >= pcr[0]) & (pts[:, 0] < pcr[3])
        & (pts[:, 1] >= pcr[1]) & (pts[:, 1] < pcr[4])
        & (pts[:, 2] >= pcr[2]) & (pts[:, 2] < pcr[5])
    )
    bm = (
        (boxes[:, 0] >= pcr[0]) & (boxes[:, 0] < pcr[3])
        & (boxes[:, 1] >= pcr[1]) & (boxes[:, 1] < pcr[4])
    )
    out = dict(sample)
    out["points"] = pts[pm]
    out["gt_boxes"] = boxes[bm]
    out["gt_labels"] = sample["gt_labels"][bm]
    out["gt_vel"] = vel[bm]
    if "gt_attrs" in sample:
        out["gt_attrs"] = sample["gt_attrs"][bm]
    return out


def _filter_range_nus(sample: Dict, pcr) -> Dict:
    pts = sample["points"]
    pm = (
        (pts[:, 0] >= pcr[0]) & (pts[:, 0] < pcr[3])
        & (pts[:, 1] >= pcr[1]) & (pts[:, 1] < pcr[4])
        & (pts[:, 2] >= pcr[2]) & (pts[:, 2] < pcr[5])
    )
    boxes = sample["gt_boxes"]
    bm = (
        (boxes[:, 0] >= pcr[0]) & (boxes[:, 0] < pcr[3])
        & (boxes[:, 1] >= pcr[1]) & (boxes[:, 1] < pcr[4])
    )
    out = dict(sample)
    out["points"] = pts[pm]
    out["gt_boxes"] = boxes[bm]
    out["gt_labels"] = sample["gt_labels"][bm]
    out["gt_vel"] = sample["gt_vel"][bm]
    if "gt_attrs" in sample:
        out["gt_attrs"] = sample["gt_attrs"][bm]
    return out


def _pad_nus_batch(samples, num_points: int, max_gt: int,
                   rng: np.random.RandomState):
    B = len(samples)
    points = np.zeros((B, num_points, 5), np.float32)
    pmask = np.zeros((B, num_points), bool)
    boxes = np.zeros((B, max_gt, 7), np.float32)
    labels = np.zeros((B, max_gt), np.int32)
    vel = np.zeros((B, max_gt, 2), np.float32)
    gmask = np.zeros((B, max_gt), bool)
    for b, s in enumerate(samples):
        p = s["points"]
        n = min(len(p), num_points)
        sel = rng.choice(len(p), n, replace=False) if len(p) > num_points else slice(0, n)
        points[b, :n] = p[sel]
        pmask[b, :n] = True
        g = min(len(s["gt_boxes"]), max_gt)
        boxes[b, :g] = s["gt_boxes"][:g]
        labels[b, :g] = s["gt_labels"][:g]
        vel[b, :g] = s["gt_vel"][:g]
        gmask[b, :g] = True
    return PointCloudBatch(points, pmask, boxes, labels, gmask), vel


def nuscenes_epoch_loader(
    data_root: str,
    batch_size: int,
    model_cfg,
    seed: int = 0,
    steps_per_epoch=None,
    num_points: int = 30000,
    max_gt: int = 32,
    max_sweeps: int = 9,
    augment: bool = True,
    use_native: bool = True,
):
    """Training loader over real NuScenes infos: epoch -> iterator of
    (PointCloudBatch, gt_vel [B, G, 2]), numpy (reference
    train_nuscenes_adversarial.py:93-191 trains on real infos)."""
    ds = NuScenesDataset(data_root, split="train", max_sweeps=max_sweeps,
                         use_native=use_native)
    pcr = model_cfg.voxelizer.point_cloud_range

    def epoch_iter(epoch: int):
        rng = np.random.RandomState(seed * 131 + epoch)
        order = rng.permutation(len(ds))
        n_steps = steps_per_epoch or max(len(ds) // batch_size, 1)
        for i in range(n_steps):
            start = (i * batch_size) % len(ds)
            idxs = order[start : start + batch_size]
            if len(idxs) < batch_size:
                idxs = np.concatenate([idxs, order[: batch_size - len(idxs)]])
            samples = []
            for j in idxs:
                s = ds.get(int(j))
                s = augment_nuscenes_sample(s, rng, pcr) if augment else _filter_range_nus(s, pcr)
                samples.append(s)
            b, vel = _pad_nus_batch(samples, num_points, max_gt, rng)
            yield b, vel

    return epoch_iter


def nuscenes_val_loader(
    data_root: str, batch_size: int, model_cfg, num_points: int = 30000,
    max_gt: int = 32, max_sweeps: int = 9, limit=None, seed: int = 0,
    use_native: bool = True,
):
    """Validation loader. Yields (PointCloudBatch, gt_vel, metas), numpy,
    with per-row validity flags (pad rows of the final short batch are not
    scored)."""
    ds = NuScenesDataset(data_root, split="val", max_sweeps=max_sweeps, use_native=use_native)
    pcr = model_cfg.voxelizer.point_cloud_range
    n = min(len(ds), limit) if limit else len(ds)
    rng = np.random.RandomState(seed)
    for i in range(0, n, batch_size):
        samples = [
            _filter_range_nus(ds.get(j), pcr) for j in range(i, min(i + batch_size, n))
        ]
        n_real = len(samples)
        while len(samples) < batch_size:
            samples.append(samples[-1])
        metas = []
        for b_i in range(batch_size):
            attrs = np.full(max_gt, ATTR_NONE, np.int32)
            sa = samples[b_i].get("gt_attrs")
            if sa is not None:
                g = min(len(sa), max_gt)
                attrs[:g] = sa[:g]
            metas.append({"valid": b_i < n_real, "gt_attrs": attrs})
        b, vel = _pad_nus_batch(samples, num_points, max_gt, rng)
        yield b, vel, metas


def synthetic_nuscenes_batch(
    rng: np.random.RandomState,
    batch_size: int = 1,
    num_points: int = 30000,
    max_gt: int = 32,
    num_objects: int = 12,
    point_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
):
    """Synthetic NuScenes-like scenes: 5D points, 10 classes, velocities."""
    B, P, G = batch_size, num_points, max_gt
    lo = np.asarray(point_range[:3], np.float32)
    hi = np.asarray(point_range[3:], np.float32)
    points = np.zeros((B, P, 5), np.float32)
    gt_boxes = np.zeros((B, G, 7), np.float32)
    gt_labels = np.zeros((B, G), np.int32)
    gt_vel = np.zeros((B, G, 2), np.float32)
    gt_mask = np.zeros((B, G), bool)
    names = list(NUSCENES_CLASSES)
    for b in range(B):
        n_obj = min(num_objects, G)
        labels = rng.randint(0, len(names), n_obj)
        for i, li in enumerate(labels):
            size = np.asarray(_CLASS_SIZES[names[li]], np.float32)
            size = size * rng.uniform(0.9, 1.1, 3).astype(np.float32)
            c = np.array([
                rng.uniform(lo[0] + 8, hi[0] - 8),
                rng.uniform(lo[1] + 8, hi[1] - 8),
                rng.uniform(-1.5, 0.0),
            ], np.float32)
            yaw = rng.uniform(-np.pi, np.pi)
            gt_boxes[b, i] = [c[0], c[1], c[2], size[0], size[1], size[2], yaw]
            gt_labels[b, i] = li
            gt_vel[b, i] = rng.uniform(-5, 5, 2)
            gt_mask[b, i] = True
        n_fg = int(P * 0.5)
        per = max(n_fg // n_obj, 1)
        idx = 0
        for i in range(n_obj):
            box = gt_boxes[b, i]
            local = rng.uniform(-0.5, 0.5, (per, 3)).astype(np.float32) * box[3:6]
            cth, sth = np.cos(box[6]), np.sin(box[6])
            world = local.copy()
            world[:, 0] = local[:, 0] * cth - local[:, 1] * sth
            world[:, 1] = local[:, 0] * sth + local[:, 1] * cth
            world += box[:3]
            points[b, idx:idx + per, :3] = world
            idx += per
        n_bg = P - idx
        points[b, idx:, 0] = rng.uniform(lo[0], hi[0], n_bg)
        points[b, idx:, 1] = rng.uniform(lo[1], hi[1], n_bg)
        points[b, idx:, 2] = rng.normal(-1.8, 0.1, n_bg)
        points[b, :, 3] = rng.rand(P)
        points[b, :, 4] = 0.0  # timestamp channel
    batch = PointCloudBatch(points, np.ones((B, P), bool), gt_boxes, gt_labels, gt_mask)
    return batch, gt_vel
