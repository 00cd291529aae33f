"""The port's PointPillars against the benchmark's plain reference, on the CPU
in float32, at the benchmark's test size (benchmark/tests/tiny/configs/
pointpillars-tiny.json: PointPillars' widths on a 16 m grid of 0.5 m
pillars, 256 pillars of 8 points, adversary (8, 16, 8)) and the seeded
random weights of benchmark/weights.py, the class-logit bias at 0 so that
the decode keeps detections.

Held, on three seeds: the first inline train step's scalar (the detection
loss plus the adversary's terms) and its detection loss, its head outputs,
and every leaf's gradient; the head outputs under the learned attack at its
evaluation bounds (the serve path); the reference's decode of the
program's own head outputs equal to the program's detections, bit for bit.
Both sides run the same float32 operations in the same order apart from
the PFN's and the adversary's masked statistics (K2's plain version
against the reference's sums), so measured first: the scalars and the head
outputs equal to the last bit, the widest leaf gradient 8.2e-7 of the
larger of its norm and the median leaf's. The tolerances leave ~100x room
above that and stay far under what the port computing its body in
bfloat16 gives (loss 1.3e-5 - 3.0e-4, heads 0.24 - 0.36 of their RMS,
gradients 0.66 - 0.96): `test_a_bfloat16_body_fails_the_tolerances`.
"""
import os

import pytest
import torch

from benchmark import counts, harness, scenes, weights
from benchmark.program import pointpillars as program
from benchmark.reference import pointpillars as reference
from robustpointclouds_tpu_torch.nn import perturber
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "benchmark", "tests", "tiny")
CPU = torch.device("cpu")
SEEDS = (2**31 + 57, 2**31 + 58, 2**31 + 59)
EPOCH = 5.0
LOSS_RTOL = 1e-6  # relative, of the train scalar and of the detection loss
HEAD_TOL = 1e-5   # of each head output's RMS
GRAD_TOL = 1e-4   # of the larger of the leaf's and the median leaf's gradient norm


def _cfg(compute_dtype="float32"):
    cfg = harness.load_config(os.path.join(TINY, "configs", "pointpillars-tiny.json"))
    cfg["model"]["compute_dtype"] = compute_dtype
    return cfg


@pytest.fixture(scope="module", autouse=True)
def float32_adversary():
    """The adversary's MLP in float32 on the port's side, as the reference's."""
    mp = pytest.MonkeyPatch()
    mp.setattr(perturber, "PERT_BF16", False)
    yield
    mp.undo()


def _inputs(seed):
    cfg = _cfg()
    traffic = harness.load_json(TINY, "traffic", "kitti-tiny-train.json")
    pool = harness.device_pool(scenes.pool(seed, traffic), CPU)
    ref = reference.Reference(cfg, CPU)
    return cfg, pool, ref, weights.make(ref.model, seed, CPU, 0.0)


def _rms_gap(got, want):
    want = {k: r.detach() for k, r in want.items()}
    return max(float((got[k].detach().float() - r).abs().max() / torch.sqrt((r * r).mean()))
               for k, r in want.items())


def train_gaps(cfg, pool, ref, w):
    """The first inline train step's forward and backward on both sides:
    (scalar gap, detection-loss gap, head gap, widest leaf-gradient gap,
    the program's positive anchors)."""
    t = program.trainer(cfg, CPU)
    t.init_state(state_dict=w)
    b = program.batch(pool[0])
    heads = {}
    hook = program.train_head(t).register_forward_hook(
        lambda m, a, out: heads.update(program.heads(out)))
    gt, _ = t._to_device(b, None)
    t.model.train()
    p_total, logs, _ = t._loss_fn(gt, EPOCH, None, t._points(b, None))
    p_total.backward()
    hook.remove()
    grads = {k: p.grad for k, p in t.model.named_parameters()}
    ref.model.load_state_dict(w)
    ref.model.train()
    r_total, r_det, _, r_heads = ref.train_loss(pool[0], EPOCH)
    r_total.backward()
    r_grads = {k: p.grad for k, p in ref.model.named_parameters()}
    assert set(grads) == set(r_grads)
    norms = sorted(float(g.norm()) for g in r_grads.values())
    median = norms[len(norms) // 2]
    grad_gap = max(float((grads[k] - g).norm()) / max(float(g.norm()), median)
                   for k, g in r_grads.items())
    p_total, r_total = float(p_total.detach()), float(r_total.detach())
    scalar_gap = abs(p_total - r_total) / abs(r_total)
    r_det = float(r_det.detach())
    det_gap = abs(float(logs["loss"]) - r_det) / abs(r_det)
    return scalar_gap, det_gap, _rms_gap(heads, r_heads), grad_gap, float(logs["num_pos"])


@pytest.mark.parametrize("seed", SEEDS)
def test_train_step_matches_the_reference(seed):
    scalar, det, head, grad, num_pos = train_gaps(*_inputs(seed))
    assert num_pos > 0
    assert scalar <= LOSS_RTOL and det <= LOSS_RTOL
    assert head <= HEAD_TOL
    assert grad <= GRAD_TOL


def test_a_bfloat16_body_fails_the_tolerances():
    cfg, pool, ref, w = _inputs(SEEDS[0])
    scalar, det, head, grad, _ = train_gaps(_cfg("bfloat16"), pool, ref, w)
    assert head > HEAD_TOL and grad > GRAD_TOL and det > LOSS_RTOL


@pytest.mark.parametrize("seed", SEEDS)
def test_attack_eval_heads_and_decode_match_the_reference(seed):
    """The serve path under the learned attack: its head outputs against
    the reference's, and the reference's decode of the program's own head
    outputs equal to the program's detections."""
    cfg, pool, ref, w = _inputs(seed)
    serve, head = program.server(cfg, CPU, w)
    got = {}
    hook = head.register_forward_hook(lambda m, a, out: got.update(program.heads(out)))
    b = pool[1]
    dets = serve(b["points"], b["points_mask"], None, attack=True)
    hook.remove()
    ref.model.load_state_dict(w)
    ref.model.eval()
    assert _rms_gap(got, ref.eval_heads(b)) <= HEAD_TOL
    want = ref.decode(got)
    assert bool(dets[3].any())
    for p, r in zip(dets, want):
        assert p.dtype == r.dtype and torch.equal(p, r)


def test_counts_record_the_pillar_body():
    """counts.record on the reference's forward: the PFN's batch norm over
    the valid slots (the padding left out), the adversary's five over the
    same rows, no sparse conv, and the dense body's 16 + 3 convs."""
    cfg, pool, ref, w = _inputs(SEEDS[0])
    ref.model.load_state_dict(w)
    ref.model.eval()
    b = pool[0]
    recs = counts.record(ref.model, lambda: ref.eval_heads(b))
    bns = [r for r in recs if r["kind"] == "masked_bn"]
    pfn = [r for r in bns if not r["adversary"]]
    plan = reference.pointpillars.build_pillar_plan(b["points"], b["points_mask"],
                                                    ref.net_cfg.voxelizer)
    valid = int(plan["point_mask"].sum())
    slots = plan["point_mask"].numel()
    assert len(pfn) == 1 and pfn[0]["rows"] == valid < slots and pfn[0]["c"] == 64
    assert [r["rows"] for r in bns if r["adversary"]] == [valid] * 5
    assert not any(r["kind"] == "sparse_conv" for r in recs)
    dense = [r for r in recs if r["kind"] == "dense"]
    assert len(dense) == (4 + 6 + 6) + 3 + 1  # backbone, FPN deblocks, the head's three 1x1s
