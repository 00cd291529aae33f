"""KITTI 3D detection AP metric (R40 protocol), numpy implementation.

The port's own copy of robustpointclouds_tpu/eval/kitti_metric.py, the same
numpy code but for `_rotated_iou`: the rotated BEV/3D IoU goes through the
port's torch geometry (ops/boxes.py) on CPU tensors in float32, where the
JAX version runs its jitted geometry on the CPU backend. Both sides compute
the IoU in float32, in another order of operations, so a match lying within
an ulp of the class threshold (0.7 / 0.5) could flip between them.

Replaces mmdet3d's `KittiMetric`, whose rotated-IoU core is numba-CUDA in the
reference stack (requirements.txt:17; the eval scripts actively re-enable CUDA
for it, evaluate_kitti_3class.py:52-54). Scoring runs on host numpy — it is
not a training-path op.

Protocol (official KITTI object devkit, 40 recall points):
  * per class & difficulty: GTs filtered by difficulty; harder GTs and
    same-class "ignored" neighbors (Van for Car, Person_sitting for
    Pedestrian) neither count as FN nor penalize matched detections
  * score thresholds from the devkit's recall-cursor walk over matched
    detection scores (getThresholds — exact transcription, including its
    small-sample behavior); one precision slot per threshold, right-max
    smoothed, summed over slots 1..40 and divided by 40 (get_mAP_R40).

Image-plane protocol pieces (when calib + GT 2D boxes are supplied, e.g. by
data/kitti.kitti_val_loader metas):
  * '2d' metric — AP over image-plane boxes; detections are the 3D boxes
    projected through P2 @ R0 @ Tr_velo_to_cam (devkit result-file bbox).
  * 'aos' metric — 2D matching where true positives score orientation
    similarity (1 + cos(alpha_gt - alpha_dt)) / 2.
  * DontCare regions — unassigned detections whose intersection-over-
    detection-area with any DontCare box exceeds the class threshold are not
    false positives.
  * minimum-height detection filter — detections whose projected 2D height is
    below the difficulty's minimum GT height (40/25/25 px) are ignored
    (neither matchable nor FPs), mirroring the devkit's ignored-detection
    rule.
Without calib, those pieces degrade gracefully: 3d/bev APs are computed
LiDAR-only and 2d/aos report nothing.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import boxes as box_ops

# classes whose GTs are "ignored" (not FN, matches not FP) when evaluating the key class
_IGNORED_NEIGHBORS = {
    "Car": ("Van",),
    "Pedestrian": ("Person_sitting",),
    "Cyclist": (),
}

_DEFAULT_IOU_THR = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
_N_SAMPLE_PTS = 41
_MIN_HEIGHT = (40.0, 25.0, 25.0)  # devkit min GT/detection 2D height per difficulty


def project_boxes_to_image(boxes: np.ndarray, calib: Dict) -> np.ndarray:
    """Lidar-frame [N, 7] boxes -> image-plane [N, 4] (x1, y1, x2, y2) via
    P2 @ R0 @ Tr_velo_to_cam over the 8 box corners (the devkit result-file
    bbox for a 3D detection). Boxes fully behind the camera collapse to an
    empty (0-area) bbox."""
    if len(boxes) == 0:
        return np.zeros((0, 4), np.float32)
    b = np.asarray(boxes, np.float64)
    cx, cy, cz = b[:, 0], b[:, 1], b[:, 2]
    dx, dy, dz = b[:, 3], b[:, 4], b[:, 5]
    yaw = b[:, 6]
    # 8 corners in the box frame
    sx = np.array([1, 1, 1, 1, -1, -1, -1, -1]) * 0.5
    sy = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * 0.5
    sz = np.array([1, -1, 1, -1, 1, -1, 1, -1]) * 0.5
    cxr, sxr = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    lx = dx[:, None] * sx[None, :]
    ly = dy[:, None] * sy[None, :]
    lz = dz[:, None] * sz[None, :]
    wx = cx[:, None] + cxr * lx - sxr * ly
    wy = cy[:, None] + sxr * lx + cxr * ly
    wz = cz[:, None] + lz
    pts = np.stack([wx, wy, wz, np.ones_like(wx)], axis=-1)  # [N, 8, 4]
    Tr4 = np.eye(4)
    Tr4[:3] = calib["Tr_velo_to_cam"]
    R04 = np.eye(4)
    R04[:3, :3] = calib.get("R0", np.eye(3))
    cam = pts @ (R04 @ Tr4).T  # [N, 8, 4]
    # clip to a small positive depth so behind-camera corners don't explode
    depth = np.maximum(cam[:, :, 2], 1e-3)
    img = cam @ calib["P2"].T  # [N, 8, 3]
    u = img[:, :, 0] / depth
    v = img[:, :, 1] / depth
    in_front = cam[:, :, 2] > 1e-3
    any_front = np.any(in_front, axis=1)
    u = np.where(in_front, u, np.nan)
    v = np.where(in_front, v, np.nan)
    with np.errstate(all="ignore"):
        out = np.stack(
            [np.nanmin(u, 1), np.nanmin(v, 1), np.nanmax(u, 1), np.nanmax(v, 1)],
            axis=1,
        )
    out = np.where(any_front[:, None], out, 0.0)
    return np.nan_to_num(out).astype(np.float32)


def detection_alphas(boxes: np.ndarray, calib: Dict) -> np.ndarray:
    """Observation angle per detection: alpha = rot_y - atan2(x_cam, z_cam)
    with rot_y = -(yaw + pi/2) (inverse of the reader's label conversion)."""
    if len(boxes) == 0:
        return np.zeros((0,), np.float32)
    b = np.asarray(boxes, np.float64)
    Tr4 = np.eye(4)
    Tr4[:3] = calib["Tr_velo_to_cam"]
    R04 = np.eye(4)
    R04[:3, :3] = calib.get("R0", np.eye(3))
    center = np.concatenate([b[:, :3], np.ones((len(b), 1))], axis=1)
    cam = center @ (R04 @ Tr4).T
    rot_y = -(b[:, 6] + np.pi / 2.0)
    alpha = rot_y - np.arctan2(cam[:, 0], np.maximum(cam[:, 2], 1e-3))
    return alpha.astype(np.float32)


def box2d_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Axis-aligned 2D IoU matrix [n_a, n_b]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    a = np.asarray(a, np.float64)[:, None, :]
    b = np.asarray(b, np.float64)[None, :, :]
    iw = np.maximum(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), 0)
    ih = np.maximum(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), 0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return (inter / np.maximum(area_a + area_b - inter, 1e-9)).astype(np.float32)


def box2d_ioa(det: np.ndarray, dc: np.ndarray) -> np.ndarray:
    """Intersection over DETECTION area [n_det, n_dc] (devkit DontCare rule)."""
    if len(det) == 0 or len(dc) == 0:
        return np.zeros((len(det), len(dc)), np.float32)
    a = np.asarray(det, np.float64)[:, None, :]
    b = np.asarray(dc, np.float64)[None, :, :]
    iw = np.maximum(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), 0)
    ih = np.maximum(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), 0)
    inter = iw * ih
    area = np.maximum((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]), 1e-9)
    return (inter / area).astype(np.float32)


def _rotated_iou(dt_boxes: np.ndarray, gt_boxes: np.ndarray, metric: str) -> np.ndarray:
    """IoU matrix [n_dt, n_gt] via the port's geometry on CPU tensors, float32."""
    if len(dt_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(dt_boxes), len(gt_boxes)), np.float32)
    a = torch.as_tensor(np.asarray(dt_boxes, np.float32))
    b = torch.as_tensor(np.asarray(gt_boxes, np.float32))
    with torch.no_grad():
        if metric == "bev":
            iou = box_ops.rotated_bev_iou(box_ops.boxes3d_to_bev(a), box_ops.boxes3d_to_bev(b))
        else:
            iou = box_ops.rotated_iou_3d(a, b)
    return iou.numpy()


def _clean_gt(anno: Dict, class_name: str, difficulty: int):
    """Split GTs into counted (0), ignored (1), and excluded (-1)."""
    names = anno["name"]
    diffs = anno.get("difficulty", np.zeros(len(names), np.int32))
    care = np.full(len(names), -1, np.int32)
    for i, (n, d) in enumerate(zip(names, diffs)):
        if n == class_name:
            if 0 <= d <= difficulty:
                care[i] = 0
            else:
                care[i] = 1  # same class, harder difficulty: ignore
        elif n in _IGNORED_NEIGHBORS.get(class_name, ()):
            care[i] = 1
    return care


def _compute_statistics(
    iou: np.ndarray,
    dt_scores: np.ndarray,
    gt_care: np.ndarray,
    dt_valid: np.ndarray,
    min_overlap: float,
    thresh: float,
    compute_fp: bool,
    dc_ioa: Optional[np.ndarray] = None,
    sim: Optional[np.ndarray] = None,
):
    """One image, one threshold: faithful transcription of the devkit /
    mmdet3d `compute_statistics` matching state machine.

    Semantics pinned by tests/test_kitti_ap_golden.py:
      * ALL non-excluded GTs (counted AND ignored) are matched greedily in
        annotation order — an ignored GT absorbs (assigns) its best
        detection, so that detection is neither TP nor FP.
      * Pass 1 (compute_fp=False, threshold collection): the best detection
        is the highest-SCORE one above min_overlap, valid or min-height-
        ignored; only (counted GT, valid det) pairs append a threshold.
      * Pass 2 (compute_fp=True): valid detections compete by OVERLAP and
        always displace an ignored-det assignment; an ignored det is the
        fallback when no valid det matches. TP only for (counted, valid);
        FN only for counted GTs with no assignment at all.
      * FPs = unassigned valid detections above the score threshold, minus
        those absorbed by DontCare regions (image-plane metric only,
        intersection-over-detection-area > min_overlap), which also become
        assigned as they absorb.

    dt_valid == False marks IGNORED detections (projected 2D height below
    the difficulty's minimum). sim [n_dt, n_gt]: orientation similarity —
    matched TPs accumulate it.
    """
    n_dt, n_gt = iou.shape
    assigned = np.zeros(n_dt, bool)
    tp = fp = fn = 0
    sim_sum = 0.0
    thresholds = []
    below_thresh = dt_scores < thresh
    NO_DET = -10.0
    for j in range(n_gt):
        if gt_care[j] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DET
        max_overlap = 0.0
        assigned_ignored_det = False
        for i in range(n_dt):
            if assigned[i] or below_thresh[i]:
                continue
            o = iou[i, j]
            if o <= min_overlap:
                continue
            if not compute_fp:
                if dt_scores[i] > valid_detection:
                    det_idx = i
                    valid_detection = dt_scores[i]
            elif dt_valid[i] and (o > max_overlap or assigned_ignored_det):
                max_overlap = o
                det_idx = i
                valid_detection = 1.0
                assigned_ignored_det = False
            elif (not dt_valid[i]) and valid_detection == NO_DET:
                det_idx = i
                valid_detection = 1.0
                assigned_ignored_det = True
        if valid_detection == NO_DET:
            if gt_care[j] == 0:
                fn += 1
        elif gt_care[j] == 1 or not dt_valid[det_idx]:
            assigned[det_idx] = True  # absorbed: no TP, no FP, no FN
        else:
            tp += 1
            assigned[det_idx] = True
            thresholds.append(dt_scores[det_idx])
            if sim is not None:
                sim_sum += float(sim[det_idx, j])
    if compute_fp:
        fp_mask = dt_valid & ~assigned & ~below_thresh
        fp = int(np.sum(fp_mask))
        if dc_ioa is not None and len(dc_ioa) == n_dt:
            absorbed = fp_mask & (dc_ioa > min_overlap)
            fp -= int(np.sum(absorbed))
    return tp, fp, fn, thresholds, sim_sum


def eval_kitti_ap(
    gt_annos: Sequence[Dict],
    dt_annos: Sequence[Dict],
    classes: Sequence[str] = ("Car", "Pedestrian", "Cyclist"),
    difficulties: Sequence[int] = (0, 1, 2),
    metric: str = "3d",
    iou_thresholds: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """AP_R40 per (class, difficulty).

    Args:
        gt_annos/dt_annos: per-image dicts with keys
            'name' [N] str, 'boxes_3d' [N, 7] (center-z convention),
            'difficulty' [N] int (gt only), 'score' [N] (dt only).
        metric: '3d' or 'bev'.
    Returns:
        {'Car_3d_easy': AP, ...} in percent.
    """
    assert len(gt_annos) == len(dt_annos)
    iou_thresholds = iou_thresholds or _DEFAULT_IOU_THR
    image_plane = metric in ("2d", "aos")
    results: Dict[str, float] = {}

    # cache IoU matrices (shared across difficulties/thresholds)
    for cls in classes:
        min_overlap = iou_thresholds.get(cls, 0.5)
        per_image = []
        for gt, dt in zip(gt_annos, dt_annos):
            dt_sel = np.asarray(dt["name"]) == cls if len(dt["name"]) else np.zeros(0, bool)
            dt_scores = np.asarray(dt["score"], np.float32)[dt_sel]
            n_dt = len(dt_scores)
            dt_bb2 = (
                np.asarray(dt["bbox2d"], np.float32).reshape(-1, 4)[dt_sel]
                if "bbox2d" in dt and len(dt["bbox2d"]) == len(dt_sel)
                else None
            )
            if image_plane:
                if dt_bb2 is None or "bbox2d" not in gt:
                    per_image.append(None)
                    continue
                gt_bb2 = np.asarray(gt["bbox2d"], np.float32).reshape(-1, 4)
                iou = box2d_iou(dt_bb2, gt_bb2)
            else:
                dt_boxes = np.asarray(dt["boxes_3d"], np.float32).reshape(-1, 7)[dt_sel]
                gt_boxes = np.asarray(gt["boxes_3d"], np.float32).reshape(-1, 7)
                iou = _rotated_iou(dt_boxes, gt_boxes, metric)
            dc = np.asarray(
                gt.get("dontcare", np.zeros((0, 4), np.float32)), np.float32
            ).reshape(-1, 4)
            # mmdet3d applies DontCare suppression to the image-plane metric
            # only (kitti_eval computes dt-vs-dc overlaps just for metric 0)
            dc_ioa = (
                np.max(box2d_ioa(dt_bb2, dc), axis=1)
                if image_plane and dt_bb2 is not None and len(dc)
                else None
            )
            dt_h = dt_bb2[:, 3] - dt_bb2[:, 1] if dt_bb2 is not None else None
            sim = None
            if metric == "aos" and "alpha" in dt and "alpha" in gt:
                da = (
                    np.asarray(gt["alpha"], np.float32)[None, :]
                    - np.asarray(dt["alpha"], np.float32)[dt_sel][:, None]
                )
                sim = (1.0 + np.cos(da)) / 2.0
            per_image.append((iou, dt_scores, gt, dt_h, dc_ioa, sim))

        for diff in difficulties:
            diff_name = ("easy", "moderate", "hard")[diff]
            key = f"{cls}_{metric}_{diff_name}"
            usable = [e for e in per_image if e is not None]
            if image_plane and not usable:
                continue  # no image-plane data supplied; metric unavailable
            gt_cares = [_clean_gt(e[2], cls, diff) for e in usable]
            # detections below the difficulty's min projected height are
            # ignored (devkit rule); without 2D data all count
            dt_valids = [
                (e[3] >= _MIN_HEIGHT[diff]) if e[3] is not None
                else np.ones(len(e[1]), bool)
                for e in usable
            ]
            total_gt = sum(int(np.sum(c == 0)) for c in gt_cares)
            if total_gt == 0:
                results[key] = 0.0
                continue

            # pass 1: matched scores at threshold -inf, then the devkit's
            # recall-cursor threshold walk (kitti devkit getThresholds /
            # mmdet3d kitti_eval.get_thresholds — EXACT transcription,
            # including its small-sample behavior where few matched scores
            # fill few of the 41 precision slots)
            all_scores: List[float] = []
            for e, care, valid in zip(usable, gt_cares, dt_valids):
                _, _, _, ts, _ = _compute_statistics(
                    e[0], e[1], care, valid, min_overlap, -np.inf, False
                )
                all_scores.extend(ts)
            thresholds = _devkit_thresholds(all_scores, total_gt)

            # pass 2: pr curve, one precision slot per threshold index
            # (unfilled slots stay 0 like the devkit's zero-initialized
            # precision array)
            precisions = np.zeros(_N_SAMPLE_PTS)
            for i, t in enumerate(thresholds):
                tp = fp = fn = 0
                sim_total = 0.0
                for e, care, valid in zip(usable, gt_cares, dt_valids):
                    tpi, fpi, fni, _, simi = _compute_statistics(
                        e[0], e[1], care, valid, min_overlap, t, True,
                        dc_ioa=e[4], sim=e[5],
                    )
                    tp += tpi
                    fp += fpi
                    fn += fni
                    sim_total += simi
                num = sim_total if metric == "aos" else float(tp)
                precisions[i] = num / max(tp + fp, 1)
            # right-max smoothing over all 41 slots (devkit)
            for i in range(_N_SAMPLE_PTS - 2, -1, -1):
                precisions[i] = max(precisions[i], precisions[i + 1])
            # R40: average over slots 1..40 (skip slot 0 = recall 0)
            results[key] = float(np.sum(precisions[1:]) / 40.0 * 100.0)
    return results


def _devkit_thresholds(scores: Sequence[float], num_gt: int) -> List[float]:
    """The devkit's getThresholds: walk matched scores descending, keep a
    score as a threshold whenever skipping it would move recall further from
    the current 1/40-spaced recall cursor than taking it."""
    scores = np.sort(np.asarray(scores, np.float64))[::-1]
    thresholds: List[float] = []
    current_recall = 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(float(score))
        current_recall += 1.0 / (_N_SAMPLE_PTS - 1.0)
    return thresholds


class KittiMetric:
    """Accumulating evaluator mirroring the reference's val_evaluator surface
    (configs/_base_/kitti-3d-car.py:159-165)."""

    def __init__(
        self,
        classes: Sequence[str] = ("Car", "Pedestrian", "Cyclist"),
        metrics: Sequence[str] = ("3d", "bev", "2d", "aos"),
    ):
        self.classes = list(classes)
        self.metrics = list(metrics)
        self._gt: List[Dict] = []
        self._dt: List[Dict] = []

    def update(self, gt_anno: Dict, dt_anno: Dict):
        self._gt.append(gt_anno)
        self._dt.append(dt_anno)

    def update_from_arrays(
        self,
        gt_boxes: np.ndarray,
        gt_labels: np.ndarray,
        gt_mask: np.ndarray,
        dt_boxes: np.ndarray,
        dt_scores: np.ndarray,
        dt_labels: np.ndarray,
        dt_mask: np.ndarray,
        gt_difficulty: Optional[np.ndarray] = None,
        meta: Optional[Dict] = None,
    ):
        """Convenience adapter from the framework's padded batch arrays.

        `meta` (from data/kitti.kitti_val_loader) may carry the image-plane
        protocol inputs: `gt_bbox2d` [max_gt, 4], `gt_alpha` [max_gt],
        `dontcare` [D, 4], and `calib` (P2/R0/Tr_velo_to_cam) — detections are
        projected through it for the 2d/aos metrics and DontCare handling."""
        gm = np.asarray(gt_mask, bool)
        dm = np.asarray(dt_mask, bool)
        names = np.asarray(self.classes)
        gt_anno = {
            "name": names[np.asarray(gt_labels)[gm]],
            "boxes_3d": np.asarray(gt_boxes)[gm],
            "difficulty": (
                np.asarray(gt_difficulty)[gm]
                if gt_difficulty is not None
                else np.zeros(int(gm.sum()), np.int32)
            ),
        }
        dt_anno = {
            "name": names[np.asarray(dt_labels)[dm]],
            "boxes_3d": np.asarray(dt_boxes)[dm],
            "score": np.asarray(dt_scores)[dm],
        }
        meta = meta or {}
        if meta.get("gt_bbox2d") is not None:
            bb2 = np.asarray(meta["gt_bbox2d"], np.float32)
            if len(bb2) == len(gm):
                gt_anno["bbox2d"] = bb2[gm]
        if meta.get("gt_alpha") is not None:
            alp = np.asarray(meta["gt_alpha"], np.float32)
            if len(alp) == len(gm):
                gt_anno["alpha"] = alp[gm]
        if meta.get("dontcare") is not None:
            gt_anno["dontcare"] = np.asarray(meta["dontcare"], np.float32).reshape(-1, 4)
        calib = meta.get("calib")
        if calib is not None and "P2" in calib and "Tr_velo_to_cam" in calib:
            dt_anno["bbox2d"] = project_boxes_to_image(dt_anno["boxes_3d"], calib)
            dt_anno["alpha"] = detection_alphas(dt_anno["boxes_3d"], calib)
        self.update(gt_anno, dt_anno)

    def compute(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for m in self.metrics:
            out.update(eval_kitti_ap(self._gt, self._dt, self.classes, metric=m))
        # headline mAP: mean over classes at moderate difficulty, 3d
        mods = [v for k, v in out.items() if k.endswith("_3d_moderate")]
        if mods:
            out["mAP_3d_moderate"] = float(np.mean(mods))
        return out

    def reset(self):
        self._gt.clear()
        self._dt.clear()
