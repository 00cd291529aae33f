"""The port's 3D box IoU and KITTI AP metric against the JAX package, on the CPU.

`rotated_iou_3d` / `box3d_corners` against the JAX ops (float32 both sides,
another order of operations: 1e-5); the port's KittiMetric gives the JAX
KittiMetric's AP dict exactly on seeded inputs, with and without calib (the
seeds keep every match away from the 0.7 / 0.5 IoU thresholds, where an ulp
of IoU could flip a match); and the golden scenes of
tests/test_kitti_ap_golden.py are re-run against the port: each (class,
metric) against that file's independent devkit oracle (given the port's
IoU geometry, the only part it shares with the metric), and its frozen
literals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_kitti_ap_golden as golden

from robustpointclouds_tpu.eval.kitti_metric import KittiMetric as JKittiMetric
from robustpointclouds_tpu.ops import boxes as jboxes

from robustpointclouds_tpu_torch.eval import kitti_metric as tkm
from robustpointclouds_tpu_torch.ops import boxes as tboxes

from test_kitti_ap_golden import CALIB, GOLDEN, _THR, _oracle_eval, make_golden_scenes
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)


@pytest.fixture
def oracle_on_port_geometry(monkeypatch):
    """The golden oracle shares only the rotated-IoU geometry with the
    metric it checks: give it the port's (held against JAX below)."""
    monkeypatch.setattr(golden, "_rotated_iou", tkm._rotated_iou)


IOU_ATOL = 1e-5


def _random_boxes(rng, n, spread=6.0):
    centers = rng.uniform(-spread, spread, (n, 3)) * np.array([1.0, 1.0, 0.1])
    dims = rng.uniform(0.5, 4.0, (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([centers, dims, yaw], 1).astype(np.float32)


def test_box3d_corners_match_jax():
    b = _random_boxes(np.random.RandomState(0), 16)
    got = tboxes.box3d_corners(torch.from_numpy(b)).numpy()
    ref = np.asarray(jboxes.box3d_corners(jnp.asarray(b)))
    assert got.shape == (16, 8, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=IOU_ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_rotated_iou_3d_matches_jax(seed):
    rng = np.random.RandomState(seed)
    a, b = _random_boxes(rng, 24), _random_boxes(rng, 17)
    b[:4] = a[:4] + rng.uniform(-0.2, 0.2, (4, 7)).astype(np.float32)  # heavy overlaps
    b[4] = a[5]  # identical boxes: IoU 1
    got = tboxes.rotated_iou_3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jboxes.rotated_iou_3d(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (24, 17) and (ref > 0.3).sum() >= 4
    np.testing.assert_allclose(got, ref, rtol=0, atol=IOU_ATOL)
    bev = tkm._rotated_iou(a, b, "bev")
    np.testing.assert_allclose(
        bev, np.asarray(jboxes.rotated_bev_iou(jboxes.boxes3d_to_bev(jnp.asarray(a)),
                                               jboxes.boxes3d_to_bev(jnp.asarray(b)))),
        rtol=0, atol=IOU_ATOL)


def _frames(seed, n_frames=3):
    """Padded per-frame arrays: six GT boxes in front of the camera (two per
    class), detections = the GTs jittered (about one in five jittered 3 m
    off: a miss and a false positive). The counts are fixed so that every
    frame and class has the same IoU shape (the JAX metric compiles its IoU
    once per shape)."""
    rng = np.random.RandomState(seed)
    labels = np.asarray([0, 0, 1, 1, 2, 2], np.int32)
    frames = []
    for _ in range(n_frames):
        gt = np.zeros((6, 7), np.float32)
        gt[:, 0] = rng.uniform(6, 40, 6)
        gt[:, 1] = rng.uniform(-12, 12, 6)
        gt[:, 2] = -1.0
        gt[:, 3:6] = [3.9, 1.6, 1.56]
        gt[:, 6] = rng.uniform(-np.pi, np.pi, 6)
        diff = rng.randint(0, 3, 6).astype(np.int32)
        dt = gt + rng.normal(0, 0.06, (6, 7)).astype(np.float32) * [1, 1, 1, 0, 0, 0, 1]
        dt[:, 0] += (rng.rand(6) < 0.2) * 3.0
        scores = rng.uniform(0.1, 1.0, 6).astype(np.float32)
        frames.append((gt, labels, np.ones(6, bool), dt.astype(np.float32), scores, labels,
                       np.ones(6, bool), diff))
    return frames


@pytest.mark.parametrize("with_calib", [False, True])
def test_kitti_metric_matches_jax(with_calib):
    ref_m, got_m = JKittiMetric(), tkm.KittiMetric()
    for gt, labels, gmask, dt, scores, dt_labels, dmask, diff in _frames(0):
        meta = None
        if with_calib:
            meta = {"gt_bbox2d": tkm.project_boxes_to_image(gt, CALIB),
                    "gt_alpha": tkm.detection_alphas(gt, CALIB),
                    "dontcare": np.asarray([[0.0, 0.0, 20.0, 20.0]], np.float32),
                    "calib": CALIB}
        for m in (ref_m, got_m):
            m.update_from_arrays(gt, labels, gmask, dt, scores, dt_labels, dmask,
                                 gt_difficulty=diff, meta=meta)
    ref, got = ref_m.compute(), got_m.compute()
    assert sorted(got) == sorted(ref)
    assert ("Car_2d_easy" in got) == with_calib
    assert got == ref
    assert max(ref.values()) > 0.0  # the scenes match something


@pytest.mark.parametrize("cls", ["Car", "Pedestrian", "Cyclist"])
@pytest.mark.parametrize("metric", ["3d", "bev", "2d", "aos"])
def test_port_matches_golden_oracle(oracle_on_port_geometry, cls, metric):
    gts, dts = make_golden_scenes()
    res = tkm.eval_kitti_ap(gts, dts, classes=(cls,), metric=metric, iou_thresholds=_THR)
    for diff, dname in enumerate(("easy", "moderate", "hard")):
        key = f"{cls}_{metric}_{dname}"
        if key not in res:
            continue
        want = _oracle_eval(gts, dts, cls, diff, metric, _THR[cls])
        assert res[key] == pytest.approx(want, abs=1e-9), (key, res[key], want)


def test_port_matches_golden_literals():
    gts, dts = make_golden_scenes()
    for (cls, metric, diff), want in GOLDEN.items():
        res = tkm.eval_kitti_ap(gts, dts, classes=(cls,), metric=metric, iou_thresholds=_THR)
        key = f"{cls}_{metric}_{('easy', 'moderate', 'hard')[diff]}"
        assert res[key] == pytest.approx(want, abs=1e-6), (key, res[key])
