"""The port's CenterPoint against the benchmark's plain reference, on the CPU
in float32, at the benchmark's test size (benchmark/tests/tiny/configs/
centerpoint-tiny.json: the --tiny smoke grid, 25.6 m of 0.4 m voxels, at
CenterPoint's widths with the DCN head) and the seeded random weights of
benchmark/weights.py, the heatmap bias at 0 so that the decode keeps
detections.

Held: one inline train step's detection loss, head outputs and first
gradient leaf by leaf against the reference's (the reference samples the
deformable conv with grid_sample, the port by gathers; measured first on three
seeds: loss 7.8e-8, heads 5.0e-6 of their RMS, the widest leaf 1.4e-4 of
the median leaf's norm: train-mode BatchNorms over the smoke grid's 64 BEV
cells amplify float32 summation order); the reference's decode of the program's
own head outputs equal to the program's detections, bit for bit; the
per-task circle NMS against a loop transcription of mmdet3d's `circle_nms`,
ties at the radius included; the scalar radius's rule unchanged; the
deformable convs' multiply-adds in `counts.record`.
"""
import os

import numpy as np
import pytest
import torch

from benchmark import counts, harness, scenes, weights
from benchmark.program import centerpoint as program
from benchmark.reference import centerpoint as reference
from benchmark.reference import train as ref_train
from robustpointclouds_tpu_torch.models import center_detection
from robustpointclouds_tpu_torch.nn import perturber
from robustpointclouds_tpu_torch.ops import nms
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "benchmark", "tests", "tiny")
CPU = torch.device("cpu")
SEED = 2**31 + 57
EPOCH = 5.0
LOSS_RTOL = 1e-6
HEAD_TOL = 2e-5   # of each output's RMS
GRAD_TOL = 1e-3   # of the larger of the leaf's and the median leaf's norm


def _cfg():
    cfg = harness.load_config(os.path.join(TINY, "configs", "centerpoint-tiny.json"))
    cfg["model"]["compute_dtype"] = "float32"
    return cfg


@pytest.fixture(scope="module")
def setup():
    mp = pytest.MonkeyPatch()
    mp.setattr(perturber, "PERT_BF16", False)
    cfg = _cfg()
    traffic = harness.load_json(TINY, "traffic", "nus-tiny-train.json")
    pool = harness.device_pool(scenes.pool(SEED, traffic), CPU)
    ref = reference.Reference(cfg, CPU)
    w = weights.make(ref.model, SEED, CPU, 0.0)
    yield cfg, pool, ref, w
    mp.undo()


def test_train_step_matches_the_reference(setup):
    cfg, pool, ref, w = setup
    t = program.trainer(cfg, CPU)
    t.init_state(state_dict=w)
    got = {}
    hook = program.train_head(t).register_forward_hook(
        lambda m, a, out: got.update(program.heads(out)))
    logs = program.train_step(t, program.batch(pool[0]), EPOCH)
    hook.remove()
    b1 = t.train_cfg.betas[0]
    grad = {k: float(torch.linalg.vector_norm(m)) / (1 - b1) for k, m in t.state.mu.items()}
    want = ref_train.three_steps(ref, w, pool[:1], EPOCH, cfg["optim"])
    assert float(logs["loss"]) == pytest.approx(want["loss"][0], rel=LOSS_RTOL)
    assert set(got) == set(want["heads"]) and len(got) == 6 * 6
    for k, r in want["heads"].items():
        rms = float(torch.sqrt((r * r).mean()))
        assert float((got[k].detach() - r).abs().max()) <= HEAD_TOL * rms, k
    median = sorted(want["grad"].values())[len(grad) // 2]
    for k, r in want["grad"].items():
        assert abs(grad[k] - r) <= GRAD_TOL * max(r, median), k


def test_decode_of_the_programs_heads_is_the_programs_detections(setup):
    cfg, pool, ref, w = setup
    serve, head = program.server(cfg, CPU, w)
    got = {}
    hook = head.register_forward_hook(lambda m, a, out: got.update(program.heads(out)))
    b = pool[1]
    dets = serve(b["points"], b["points_mask"], None, attack=True)
    hook.remove()
    want = ref.decode(got)
    assert bool(dets[3].any())
    for p, r in zip(dets, want):
        assert p.dtype == r.dtype and torch.equal(p, r)


def _mmdet3d_circle_nms(dets: np.ndarray, thresh: float, post_max_size: int = 83):
    """mmdet3d's ops circle_nms, transcribed: dets [N, 3] (x, y, score)."""
    x1, y1, scores = dets[:, 0], dets[:, 1], dets[:, 2]
    order = scores.argsort()[::-1].astype(np.int32)
    suppressed = np.zeros(dets.shape[0], dtype=np.int32)
    keep = []
    for _i in range(dets.shape[0]):
        i = order[_i]
        if suppressed[i] == 1:
            continue
        keep.append(i)
        for _j in range(_i + 1, dets.shape[0]):
            j = order[_j]
            if suppressed[j] == 1:
                continue
            dist = (x1[i] - x1[j]) ** 2 + (y1[i] - y1[j]) ** 2
            if dist <= thresh:
                suppressed[j] = 1
    return keep[:post_max_size]


def _sorted_candidates(rng, n, lattice):
    """n centres (on a unit lattice, so that squared distances tie with
    integer radii) and distinct scores, in descending score order."""
    xy = (rng.integers(0, 6, (n, 2)) if lattice else rng.uniform(0, 6, (n, 2))).astype(np.float32)
    scores = rng.permutation(n).astype(np.float32) / n + 0.01
    order = np.argsort(-scores, kind="stable")
    return xy[order], scores[order]


@pytest.mark.parametrize("radius", [4, 12, 10, 1, 0.85, 0.175])
@pytest.mark.parametrize("lattice", [False, True])
def test_per_task_circle_nms_is_mmdet3ds(radius, lattice):
    rng = np.random.default_rng(int(radius * 1000) + lattice)
    xy, scores = _sorted_candidates(rng, 40, lattice)
    keep = nms.circle_nms(torch.from_numpy(xy)[None], torch.ones(1, 40, dtype=torch.bool),
                          torch.tensor([float(radius)]))[0]
    want = _mmdet3d_circle_nms(np.concatenate([xy, scores[:, None]], 1), float(np.float32(radius)))
    assert sorted(torch.nonzero(keep)[:, 0].tolist()) == sorted(want)


@pytest.mark.parametrize("radius", [1.0, 2.0, 4.0])
def test_scalar_radius_keeps_the_strict_distance_rule(radius):
    rng = np.random.default_rng(7)
    xy, _ = _sorted_candidates(rng, 40, True)
    keep = nms.circle_nms(torch.from_numpy(xy), torch.ones(40, dtype=torch.bool), radius)
    want = []
    for i in range(40):  # suppressed when closer than the radius to a kept one
        if all(np.hypot(*(xy[i] - xy[j])) >= radius for j in want):
            want.append(i)
    assert torch.nonzero(keep)[:, 0].tolist() == want
    assert center_detection.CenterHeadConfig(tasks=(("car",),)).circle_radius == 4.0


def test_decode_radius_per_task_or_one(setup, monkeypatch):
    """A tuple reaches circle NMS as one radius a task, a float as itself;
    a tuple of another length than the tasks raises."""
    cfg, pool, ref, w = setup
    net = program.model_config(cfg["model"])
    seen = []
    orig = nms.circle_nms
    monkeypatch.setattr(nms, "circle_nms", lambda c, v, r: seen.append(r) or orig(c, v, r))
    preds = [{k: torch.randn(2, 8, 8, d) for k, d in
              [("heatmap", len(t)), ("reg", 2), ("height", 1), ("dim", 3), ("rot", 2),
               ("vel", 2)]} for t in net.tasks]
    center_detection.centerpoint_decode(preds, net.head)
    center_detection.centerpoint_decode(preds, net.head._replace(circle_radius=4.0))
    assert seen[0].tolist() == [[np.float32(r) for r in net.head.circle_radius]] * 2
    assert seen[1] == 4.0
    with pytest.raises(ValueError, match="radii"):
        center_detection.centerpoint_decode(preds, net.head._replace(circle_radius=(4.0, 1.0)))


def test_counts_record_the_deformable_convs(setup):
    cfg, pool, ref, w = setup
    ref.model.load_state_dict(w)
    ref.model.eval()
    b = pool[0]
    recs = counts.record(ref.model, lambda: ref.eval_heads(b))
    bsz, h, wd = b["points"].shape[0], 8, 8
    dcn = bsz * h * wd * 64 * (64 // 4) * 9  # an output element reads 16 channels x 9 taps
    offsets = bsz * h * wd * 18 * 64 * 9
    dense = [r["macs"] for r in recs if r["kind"] == "dense"]
    assert dense.count(dcn) == 12 and dense.count(offsets) == 12
    assert sum(r["kind"] == "sparse_conv" for r in recs) == 21
    assert counts.forward_flops(recs) >= 2.0 * 12 * (dcn + offsets)
