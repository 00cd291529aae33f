"""NuScenes-style detection metric, center-distance mAP + NDS (the port's own numpy copy of robustpointclouds_tpu/eval/nuscenes_metric.py).

The devkit's protocol, self-contained:
  * matching by BEV center distance at thresholds {0.5, 1, 2, 4} m;
  * AP = normalized area under the 101-point interpolated PR curve above
    (min_recall 0.1, min_precision 0.1); mAP = mean over classes x thresholds;
  * TP errors at the 2.0 m threshold over matched pairs: ATE (BEV center
    distance), ASE (1 - IoU of center/yaw-aligned boxes), AOE (smallest yaw
    delta; period pi for barriers), AVE (L2 of the velocity delta) and AAE
    (1 - attribute accuracy over TPs with a real GT attribute), with the
    devkit's class exclusions (no AOE for traffic cones, no AVE/AAE for
    barriers/cones);
  * NDS = (5*mAP + sum over the five TP metrics of (1 - min(err, 1))) / 10;
    a TP metric with no measured values anywhere scores its worst case 1.0.

GT attributes ride in per-frame annos as 'attrs' [N] int indices into
ATTRIBUTES; detection attributes default to mmdet3d's velocity-based rule
(:func:`default_detection_attrs`) when not supplied. The code below the
header is the JAX package's, unchanged, so both give the same dict.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
_MIN_RECALL = 0.1
_MIN_PRECISION = 0.1

# canonical attribute vocabulary (nuscenes devkit names); index 8 = no attr
ATTRIBUTES = (
    "cycle.with_rider", "cycle.without_rider",
    "pedestrian.moving", "pedestrian.standing",
    "pedestrian.sitting_lying_down",
    "vehicle.moving", "vehicle.parked", "vehicle.stopped",
    "None",
)
ATTR_NONE = len(ATTRIBUTES) - 1
_ATTR_TO_ID = {a: i for i, a in enumerate(ATTRIBUTES)}

# devkit class exclusions for TP error metrics
_NO_ORIENT = {"traffic_cone"}
_NO_VEL = {"barrier", "traffic_cone"}
_NO_ATTR = {"barrier", "traffic_cone"}
_YAW_PERIOD_PI = {"barrier"}

# mmdet3d NuScenesDataset.DefaultAttribute + its velocity rule
_DEFAULT_ATTR = {
    "car": "vehicle.parked", "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked", "truck": "vehicle.parked",
    "bus": "vehicle.moving", "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked", "bicycle": "cycle.without_rider",
    "barrier": "None", "traffic_cone": "None",
}
_VEHICLES = {"car", "construction_vehicle", "bus", "truck", "trailer"}
_CYCLES = {"bicycle", "motorcycle"}


def default_detection_attrs(cls: str, vels: Optional[np.ndarray], n: int) -> np.ndarray:
    """mmdet3d's velocity-based detection attribute assignment
    (nuscenes_dataset._format_bbox): speed > 0.2 -> moving/with_rider;
    otherwise the per-class default (pedestrian -> standing, bus -> stopped)."""
    out = np.full(n, _ATTR_TO_ID.get(_DEFAULT_ATTR.get(cls, "None"), ATTR_NONE),
                  np.int32)
    if vels is None or n == 0:
        return out
    speed = np.linalg.norm(np.asarray(vels, np.float32).reshape(n, 2), axis=1)
    moving = speed > 0.2
    if cls in _VEHICLES:
        out[moving] = _ATTR_TO_ID["vehicle.moving"]
    elif cls in _CYCLES:
        out[moving] = _ATTR_TO_ID["cycle.with_rider"]
    if cls == "pedestrian":
        out[~moving] = _ATTR_TO_ID["pedestrian.standing"]
    elif cls == "bus":
        out[~moving] = _ATTR_TO_ID["vehicle.stopped"]
    return out


def _aligned_iou3d(g: np.ndarray, d: np.ndarray) -> float:
    """3D IoU of two boxes after aligning centers and yaw (devkit scale_iou)."""
    inter = float(np.prod(np.minimum(g[3:6], d[3:6])))
    union = float(np.prod(g[3:6])) + float(np.prod(d[3:6])) - inter
    return inter / max(union, 1e-9)


def _yaw_diff(g: float, d: float, period: float) -> float:
    diff = (d - g) % period
    return float(min(diff, period - diff))


def _ap_single(
    gt_boxes: List[np.ndarray],
    gt_vels: List[Optional[np.ndarray]],
    dt_boxes: List[np.ndarray],
    dt_scores: List[np.ndarray],
    dt_vels: List[Optional[np.ndarray]],
    thr: float,
    cls: str,
    gt_attrs: Optional[List[Optional[np.ndarray]]] = None,
    dt_attrs: Optional[List[np.ndarray]] = None,
):
    """AP for one class at one distance threshold, plus TP error stats."""
    total_gt = sum(len(g) for g in gt_boxes)
    if total_gt == 0:
        return None
    rows = []  # (score, is_tp, ate, ase, aoe, ave, attr_ok)
    period = np.pi if cls in _YAW_PERIOD_PI else 2 * np.pi
    for fi, (g, gv, d, s, dv) in enumerate(
        zip(gt_boxes, gt_vels, dt_boxes, dt_scores, dt_vels)
    ):
        ga = gt_attrs[fi] if gt_attrs is not None else None
        da = dt_attrs[fi] if dt_attrs is not None else None
        order = np.argsort(-s)
        taken = np.zeros(len(g), bool)
        for i in order:
            if len(g) == 0:
                rows.append((s[i], False, 0.0, 0.0, 0.0, 0.0, np.nan))
                continue
            dist = np.linalg.norm(g[:, :2] - d[i, :2][None], axis=1)
            dist = np.where(taken, np.inf, dist)
            j = int(np.argmin(dist))
            if dist[j] <= thr:
                taken[j] = True
                ase = 1.0 - _aligned_iou3d(g[j], d[i])
                aoe = _yaw_diff(float(g[j, 6]), float(d[i, 6]), period)
                if gv is not None and dv is not None:
                    ave = float(np.linalg.norm(gv[j] - dv[i]))
                else:
                    ave = np.nan
                # devkit attr_acc: only GTs carrying a real attribute count
                if (ga is not None and da is not None
                        and int(ga[j]) != ATTR_NONE):
                    attr_ok = 1.0 if int(ga[j]) == int(da[i]) else 0.0
                else:
                    attr_ok = np.nan
                rows.append((s[i], True, float(dist[j]), ase, aoe, ave, attr_ok))
            else:
                rows.append((s[i], False, 0.0, 0.0, 0.0, 0.0, np.nan))
    if not rows:
        return {"ap": 0.0}
    rows.sort(key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in rows])
    fp = np.cumsum([not r[1] for r in rows])
    recall = tp / total_gt
    precision = tp / np.maximum(tp + fp, 1)
    # devkit: interpolate onto 101 recall points, clip the low-confidence zone
    rec_interp = np.linspace(0, 1, 101)
    prec_interp = np.interp(rec_interp, recall, precision, right=0.0)
    prec = prec_interp[rec_interp >= _MIN_RECALL]
    prec = np.maximum(prec - _MIN_PRECISION, 0.0) / (1.0 - _MIN_PRECISION)
    out = {"ap": float(np.mean(prec))}
    matched = [r for r in rows if r[1]]
    if matched:
        out["trans_err"] = float(np.mean([r[2] for r in matched]))
        out["scale_err"] = float(np.mean([r[3] for r in matched]))
        out["orient_err"] = float(np.mean([r[4] for r in matched]))
        aves = [r[5] for r in matched if not np.isnan(r[5])]
        if aves:
            out["vel_err"] = float(np.mean(aves))
        accs = [r[6] for r in matched if not np.isnan(r[6])]
        if accs:
            out["attr_err"] = float(1.0 - np.mean(accs))
    else:
        out.update(trans_err=1.0, scale_err=1.0, orient_err=1.0)
    return out


def _rows(arr, width_default: int = 7) -> np.ndarray:
    """Coerce a frame's boxes to 2D [N, >=7] (size-0 inputs stay valid)."""
    a = np.asarray(arr, np.float32)
    if a.ndim != 2:
        a = a.reshape(-1, width_default) if a.size else np.zeros((0, width_default), np.float32)
    return a


def eval_nuscenes_map(
    gt_annos: Sequence[Dict],
    dt_annos: Sequence[Dict],
    classes: Sequence[str],
) -> Dict[str, float]:
    """Center-distance mAP + NDS per the devkit protocol.

    Annos per frame: gt {'boxes_3d' [N,7], 'labels' [N], 'vel' [N,2] optional};
    dt {'boxes_3d' [M,>=7] (columns 7:9 = vel if present), 'labels' [M],
    'score' [M], 'vel' [M,2] optional}.
    """
    results: Dict[str, float] = {}
    aps = []
    errs = {"trans_err": [], "scale_err": [], "orient_err": [], "vel_err": [],
            "attr_err": []}
    for ci, cls in enumerate(classes):
        cls_aps = []
        for thr in DIST_THRESHOLDS:
            gt_b, gt_v, dt_b, dt_s, dt_v = [], [], [], [], []
            gt_a, dt_a = [], []
            for gt, dt in zip(gt_annos, dt_annos):
                gsel = np.asarray(gt["labels"]) == ci
                dsel = np.asarray(dt["labels"]) == ci
                gb = _rows(gt["boxes_3d"])[gsel]
                db = _rows(dt["boxes_3d"])[dsel]
                gt_b.append(gb[:, :7])
                dt_b.append(db[:, :7])
                dt_s.append(np.asarray(dt["score"], np.float32)[dsel])
                gv = gt.get("vel")
                gt_v.append(np.asarray(gv, np.float32)[gsel] if gv is not None else None)
                if dt.get("vel") is not None:
                    dvel = np.asarray(dt["vel"], np.float32)[dsel]
                elif db.shape[1] >= 9:
                    dvel = db[:, 7:9]
                else:
                    dvel = None
                dt_v.append(dvel)
                ga = gt.get("attrs")
                gt_a.append(np.asarray(ga, np.int32)[gsel] if ga is not None else None)
                if dt.get("attrs") is not None:
                    dt_a.append(np.asarray(dt["attrs"], np.int32)[dsel])
                else:
                    # mmdet3d submission rule: derive from class + velocity
                    dt_a.append(default_detection_attrs(cls, dvel, len(db)))
            r = _ap_single(gt_b, gt_v, dt_b, dt_s, dt_v, thr, cls,
                           gt_attrs=gt_a, dt_attrs=dt_a)
            if r is None:
                continue
            cls_aps.append(r["ap"])
            if thr == TP_THRESHOLD:
                if "trans_err" in r:
                    errs["trans_err"].append(r["trans_err"])
                    errs["scale_err"].append(r["scale_err"])
                    if cls not in _NO_ORIENT:
                        errs["orient_err"].append(r["orient_err"])
                    if cls not in _NO_VEL and "vel_err" in r:
                        errs["vel_err"].append(r["vel_err"])
                    if cls not in _NO_ATTR and "attr_err" in r:
                        errs["attr_err"].append(r["attr_err"])
        if cls_aps:
            ap_c = float(np.mean(cls_aps))
            results[f"{cls}_AP"] = ap_c * 100.0
            aps.append(ap_c)
    m_ap = float(np.mean(aps)) if aps else 0.0
    results["mAP"] = m_ap * 100.0

    tp_scores = []
    for name, key in (("mATE", "trans_err"), ("mASE", "scale_err"),
                      ("mAOE", "orient_err"), ("mAVE", "vel_err"),
                      ("mAAE", "attr_err")):
        vals = errs[key]
        # devkit NDS formula: ALWAYS five TP metrics; one with no measured
        # values anywhere (e.g. attributes absent from the infos) scores its
        # worst case err=1.0 instead of being renormalized away
        mean_err = float(np.mean(vals)) if vals else 1.0
        results[name] = mean_err
        tp_scores.append(max(1.0 - min(mean_err, 1.0), 0.0))
    nds = (5 * m_ap + sum(tp_scores)) / 10.0
    results["NDS"] = nds * 100.0
    results["NDS_simplified"] = results["NDS"]  # backward-compat alias
    return results
