"""KITTI reader and validation loader, numpy only (counterpart of robustpointclouds_tpu/data/kitti.py).

Reads the raw KITTI layout (velodyne .bin + label_2 + calib + ImageSets);
no info-pkl step. Labels live in the camera frame (location = bottom
centre, dims = (h, w, l), rotation_y) and are converted to the lidar-frame
centre-z convention (x, y, z_center, dx=l, dy=w, dz=h, yaw) with
yaw = -rotation_y - pi/2; difficulty follows the devkit rules (image bbox
height / occlusion / truncation).

The reader, `KittiDataset`, `load_infos_pkl`, the training loader
`kitti_epoch_loader` and `kitti_val_loader` yield the same numpy batches
(and per-row metas) as the JAX package, which wraps its arrays in jnp. The
training loader keeps both of the JAX package's paths: native IO + global
augmentation (data/native.py) with the per-object stage (GT-paste, object
noise) in numpy on top, or all-numpy through transforms.augment_sample.
"""
from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import transforms as T
from .synthetic import PointCloudBatch

CLASSES = ("Car", "Pedestrian", "Cyclist")
_CLS_TO_ID = {c: i for i, c in enumerate(CLASSES)}


def kitti_available(data_root: str) -> bool:
    return os.path.isdir(os.path.join(data_root, "training", "velodyne_reduced")) or (
        os.path.isdir(os.path.join(data_root, "training", "velodyne"))
    )


def _velodyne_dir(data_root: str, split: str = "training") -> str:
    reduced = os.path.join(data_root, split, "velodyne_reduced")
    return reduced if os.path.isdir(reduced) else os.path.join(data_root, split, "velodyne")


def read_points(path: str) -> np.ndarray:
    """Load a velodyne .bin: [N, 4] float32 (x, y, z, intensity)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_calib(path: str) -> Dict[str, np.ndarray]:
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            out[key.strip()] = np.asarray([float(v) for v in vals.split()], np.float64)
    calib = {}
    if "P2" in out:
        calib["P2"] = out["P2"].reshape(3, 4)
    r0 = out.get("R0_rect", out.get("R_rect"))
    if r0 is not None:
        calib["R0"] = r0.reshape(3, 3)
    tr = out.get("Tr_velo_to_cam", out.get("Tr_velo_cam"))
    if tr is not None:
        calib["Tr_velo_to_cam"] = tr.reshape(3, 4)
    return calib


def _difficulty(bbox_h: float, occluded: int, truncated: float) -> int:
    if bbox_h >= 40 and occluded <= 0 and truncated <= 0.15:
        return 0
    if bbox_h >= 25 and occluded <= 1 and truncated <= 0.3:
        return 1
    if bbox_h >= 25 and occluded <= 2 and truncated <= 0.5:
        return 2
    return -1


def read_label(path: str, calib: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Parse label_2 txt -> lidar-frame boxes + labels + difficulty, and the
    per-GT image-plane data of the devkit's 2D/AOS metrics and DontCare
    handling: `bbox2d` [N, 4], `alpha` [N] (the observation angle from the
    label file) and `dontcare` [D, 4] image regions."""
    names, boxes, difficulty, bbox2d, alphas, dontcare = [], [], [], [], [], []
    R0 = calib.get("R0", np.eye(3))
    Tr = calib.get("Tr_velo_to_cam")
    if Tr is None:
        raise ValueError("calib must contain Tr_velo_to_cam")
    Tr4 = np.eye(4)
    Tr4[:3] = Tr
    R04 = np.eye(4)
    R04[:3, :3] = R0
    cam_to_velo = np.linalg.inv(R04 @ Tr4)

    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 15:
                continue
            name = parts[0]
            bbox = [float(v) for v in parts[4:8]]
            if name == "DontCare":
                dontcare.append(bbox)
                continue
            truncated, occluded = float(parts[1]), int(float(parts[2]))
            alpha = float(parts[3])
            h, w, l = (float(v) for v in parts[8:11])
            loc_cam = np.asarray([float(v) for v in parts[11:14]] + [1.0])
            rot_y = float(parts[14])
            loc_velo = (cam_to_velo @ loc_cam)[:3]
            z_center = loc_velo[2] + h / 2.0  # label z is the box bottom
            yaw = -rot_y - np.pi / 2.0
            names.append(name)
            boxes.append([loc_velo[0], loc_velo[1], z_center, l, w, h, yaw])
            difficulty.append(_difficulty(bbox[3] - bbox[1], occluded, truncated))
            bbox2d.append(bbox)
            alphas.append(alpha)
    return {
        "name": np.asarray(names),
        "boxes_3d": np.asarray(boxes, np.float32).reshape(-1, 7),
        "difficulty": np.asarray(difficulty, np.int32),
        "bbox2d": np.asarray(bbox2d, np.float32).reshape(-1, 4),
        "alpha": np.asarray(alphas, np.float32),
        "dontcare": np.asarray(dontcare, np.float32).reshape(-1, 4),
    }


def load_infos_pkl(path: str) -> List[Dict]:
    """Read an mmdet3d kitti_infos_*.pkl (compat path for preprocessed data)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return data["data_list"] if isinstance(data, dict) and "data_list" in data else data


class KittiDataset:
    """Raw-layout KITTI dataset over an ImageSets split file."""

    def __init__(self, data_root: str, split: str = "train", classes: Sequence[str] = CLASSES):
        self.data_root = data_root
        self.classes = list(classes)
        split_file = os.path.join(data_root, "ImageSets", f"{split}.txt")
        if os.path.isfile(split_file):
            with open(split_file) as f:
                self.ids = [line.strip() for line in f if line.strip()]
        else:
            vdir = _velodyne_dir(data_root)
            self.ids = sorted(os.path.splitext(n)[0] for n in os.listdir(vdir))
        self._vdir = _velodyne_dir(data_root)
        self._ldir = os.path.join(data_root, "training", "label_2")
        self._cdir = os.path.join(data_root, "training", "calib")

    def __len__(self):
        return len(self.ids)

    def get(self, idx: int) -> Dict:
        fid = self.ids[idx]
        points = read_points(os.path.join(self._vdir, f"{fid}.bin"))
        calib = read_calib(os.path.join(self._cdir, f"{fid}.txt"))
        anno = read_label(os.path.join(self._ldir, f"{fid}.txt"), calib)
        keep = np.isin(anno["name"], self.classes)
        labels = np.asarray([_CLS_TO_ID.get(n, -1) for n in anno["name"][keep]], np.int32)
        return {
            "frame_id": fid,
            "points": points,
            "gt_boxes": anno["boxes_3d"][keep],
            "gt_labels": labels,
            "gt_difficulty": anno["difficulty"][keep],
            "gt_bbox2d": anno["bbox2d"][keep],
            "gt_alpha": anno["alpha"][keep],
            "dontcare": anno["dontcare"],
            "calib": calib,
            "raw_anno": anno,
        }


def _pad_batch(samples: List[Dict], num_points: int, max_gt: int,
               rng: Optional[np.random.RandomState] = None) -> PointCloudBatch:
    B = len(samples)
    points = np.zeros((B, num_points, 4), np.float32)
    pmask = np.zeros((B, num_points), bool)
    boxes = np.zeros((B, max_gt, 7), np.float32)
    labels = np.zeros((B, max_gt), np.int32)
    gmask = np.zeros((B, max_gt), bool)
    # seeded subsample: repeat runs on the same data must score identically
    rng = rng or np.random.RandomState(0)
    for b, s in enumerate(samples):
        p = s["points"]
        n = min(len(p), num_points)
        sel = rng.choice(len(p), n, replace=False) if len(p) > num_points else slice(0, n)
        points[b, :n] = p[sel]
        pmask[b, :n] = True
        g = min(len(s["gt_boxes"]), max_gt)
        boxes[b, :g] = s["gt_boxes"][:g]
        labels[b, :g] = s["gt_labels"][:g]
        gmask[b, :g] = True
    return PointCloudBatch(points, pmask, boxes, labels, gmask)


def _paste_and_noise_padded(pts: np.ndarray, pmask: np.ndarray, boxes: np.ndarray,
                            labels: np.ndarray, gmask: np.ndarray, gt_db,
                            rng: np.random.RandomState, num_points: int, max_gt: int):
    """Per-object stage on top of the native path's padded output: GT-paste
    (ObjectSample / db_sampler) + ObjectNoise, then re-pad, in place. The
    native path does IO + global flip / rotation / scale + range filter +
    pad, so both loader paths train on the same augmentations."""
    for b in range(pts.shape[0]):
        sample = {
            "points": pts[b][pmask[b].astype(bool)],
            "gt_boxes": boxes[b][gmask[b].astype(bool)],
            "gt_labels": labels[b][gmask[b].astype(bool)],
        }
        if gt_db is not None:
            gt_db.collect(sample)
            sample = gt_db.paste(sample, rng)
        sample = T.object_noise(sample, rng)
        p = sample["points"]
        n = min(len(p), num_points)
        sel = rng.choice(len(p), n, replace=False) if len(p) > num_points else slice(0, n)
        pts[b, :n] = p[sel]
        pts[b, n:] = 0
        pmask[b, :n] = True
        pmask[b, n:] = False
        g = min(len(sample["gt_boxes"]), max_gt)
        boxes[b, :g] = sample["gt_boxes"][:g]
        boxes[b, g:] = 0
        labels[b, :g] = sample["gt_labels"][:g]
        labels[b, g:] = 0
        gmask[b, :g] = True
        gmask[b, g:] = False
    return pts, pmask, boxes, labels, gmask


def kitti_epoch_loader(data_root: str, batch_size: int, model_cfg, seed: int = 0,
                       steps_per_epoch: Optional[int] = None, num_points: int = 20000,
                       max_gt: int = 50, use_native: bool = True
                       ) -> Callable[[int], Iterator[PointCloudBatch]]:
    """Training loader: epoch -> iterator of numpy PointCloudBatches.

    The epoch's frame order is a permutation drawn from
    `RandomState(seed * 131 + epoch)`, the same stream every augmentation of
    the epoch draws from; the last batch wraps around to the order's start
    (as often as it takes when the split holds fewer than `batch_size`
    frames, where the JAX loader yields a short batch).
    `use_native=True` reads and globally augments each batch in the native
    library (which must build: no quiet fallback), then runs GT-paste and
    object noise in numpy; `use_native=False` runs
    transforms.augment_sample per frame. GT-paste (the db_sampler's default
    groups, Car 15, Pedestrian 10, Cyclist 10) is pre-seeded from
    `<data_root>/kitti_dbinfos_train.pkl` when it is there (the reference
    db_sampler's info_path), and collects crops on the fly from every batch
    either way."""
    from . import native

    ds = KittiDataset(data_root, split="train")
    pcr = model_cfg.voxelizer.point_cloud_range
    if use_native:
        native.get_lib()  # builds now: a missing compiler raises here
    dbinfos = os.path.join(data_root, "kitti_dbinfos_train.pkl")
    if os.path.isfile(dbinfos):
        gt_db = T.GroundTruthDatabase.from_dbinfos(dbinfos, data_root, classes=tuple(ds.classes))
        n_seed = sum(len(v) for v in gt_db._db.values())
        print(f"[gt-paste] seeded {n_seed} crops from {dbinfos}", flush=True)
    else:
        gt_db = T.GroundTruthDatabase()

    def native_batch(idxs, rng):
        paths, n_boxes = [], []
        boxes_pad = np.zeros((batch_size, max_gt, 7), np.float32)
        labels_pad = np.zeros((batch_size, max_gt), np.int32)
        for b, j in enumerate(idxs):
            fid = ds.ids[int(j)]
            paths.append(os.path.join(ds._vdir, f"{fid}.bin"))
            calib = read_calib(os.path.join(ds._cdir, f"{fid}.txt"))
            anno = read_label(os.path.join(ds._ldir, f"{fid}.txt"), calib)
            keep = np.isin(anno["name"], ds.classes)
            bx = anno["boxes_3d"][keep][:max_gt]
            boxes_pad[b, :len(bx)] = bx
            labels_pad[b, :len(bx)] = [_CLS_TO_ID.get(n, -1) for n in anno["name"][keep][:max_gt]]
            n_boxes.append(len(bx))
        # boxes_pad is augmented in place
        pts, pmask, box_keep, _ = native.prepare_batch(
            paths, boxes_pad, np.asarray(n_boxes, np.int32), pcr, max_points=num_points,
            seed=int(rng.randint(0, 2**31)))
        gmask = box_keep & (np.arange(max_gt)[None, :] < np.asarray(n_boxes)[:, None])
        return PointCloudBatch(*_paste_and_noise_padded(
            pts, pmask, boxes_pad, labels_pad, gmask, gt_db, rng, num_points, max_gt))

    def epoch_iter(epoch: int):
        rng = np.random.RandomState(seed * 131 + epoch)
        order = rng.permutation(len(ds))
        n_steps = steps_per_epoch or max(len(ds) // batch_size, 1)
        for i in range(n_steps):
            start = (i * batch_size) % len(ds)
            idxs = order[start:start + batch_size]
            if len(idxs) < batch_size:  # wrap around (cyclically past a split smaller than B)
                idxs = np.concatenate([idxs, np.resize(order, batch_size - len(idxs))])
            if use_native:
                yield native_batch(idxs, rng)
                continue
            samples = [T.augment_sample(ds.get(int(j)), rng, pcr, gt_db=gt_db) for j in idxs]
            yield _pad_batch(samples, num_points, max_gt, rng=rng)

    return epoch_iter


def kitti_val_loader(data_root: str, batch_size: int, model_cfg, num_points: int = 20000,
                     max_gt: int = 50, limit: Optional[int] = None, seed: int = 0
                     ) -> Iterator[tuple]:
    """Validation loader. Yields `(PointCloudBatch, metas)`; `metas` is a
    per-row list of dicts: `gt_difficulty` [max_gt] (KITTI easy/mod/hard per
    GT), `gt_bbox2d` [max_gt, 4], `gt_alpha` [max_gt], `dontcare` [D, 4],
    `calib`, `valid` (False on rows that only pad the final short batch and
    must not be scored) and `frame_id`."""
    ds = KittiDataset(data_root, split="val")
    pcr = model_cfg.voxelizer.point_cloud_range
    n = min(len(ds), limit) if limit else len(ds)
    rng = np.random.RandomState(seed)
    for i in range(0, n, batch_size):
        samples = [T.filter_range(ds.get(j), pcr) for j in range(i, min(i + batch_size, n))]
        n_real = len(samples)
        while len(samples) < batch_size:
            samples.append(samples[-1])
        metas = []
        for b_i, s in enumerate(samples):
            diff = np.zeros(max_gt, np.int32)
            bb2 = np.zeros((max_gt, 4), np.float32)
            alp = np.zeros(max_gt, np.float32)
            g = min(len(s.get("gt_difficulty", [])), max_gt)
            if g:
                diff[:g] = s["gt_difficulty"][:g]
            g2 = min(len(s.get("gt_bbox2d", [])), max_gt)
            if g2:
                bb2[:g2] = s["gt_bbox2d"][:g2]
                alp[:g2] = s["gt_alpha"][:g2]
            metas.append({
                "gt_difficulty": diff,
                "gt_bbox2d": bb2,
                "gt_alpha": alp,
                "dontcare": s.get("dontcare", np.zeros((0, 4), np.float32)),
                "calib": s.get("calib"),
                "valid": b_i < n_real,
                "frame_id": s.get("frame_id", ""),
            })
        yield _pad_batch(samples, num_points, max_gt, rng=rng), metas
