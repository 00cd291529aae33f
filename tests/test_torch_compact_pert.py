"""The compact-point voxel adversary (RPC_COMPACT_PERT) of the port.

With `models/voxelnet.COMPACT_PERT` the adversary runs over the compact
point list [B*P, F] and its bounded deltas are gathered into the voxel
slots through the plan's slot maps (`slot_point` / `point_slot`). On the
CPU, in float32 (PERT_BF16 off on both sides) at the smoke grids:
  * SECOND's compact train step against JAX's compact step on the same
    native plan and weights: the logs, every gradient and the BatchNorm
    running statistics, at tests/test_torch_train.py's tolerances;
  * the compact form against the port's padded form, SECOND, PointPillars
    and CenterPoint, one train step and an attack=True forward, at the JAX
    package's own compact-vs-padded tolerances (tests/test_compact_pert.py:
    the same multiset of rows, summed in another order);
  * the plan-fed compact step bitwise equal to the inline compact step (the
    same code on bit-equal plans), each family;
  * the gather's backward: points that did not survive voxelisation get a
    zero gradient, and each surviving point its slot's;
  * the model, not its caller, says that a plan-fed forward reads the
    points (`reads_points`), and the compact adversary raises without them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.cli.common import tiny_voxelnet_cfg as j_tiny_voxelnet_cfg
from robustpointclouds_tpu.data.native_plan import build_plan_native as j_build_plan_native
from robustpointclouds_tpu.data.structures import PointCloudBatch as JBatch
from robustpointclouds_tpu.models import voxelnet as jvn
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig, Trainer as JTrainer

from robustpointclouds_tpu_torch.cli.common import tiny_pointpillars_cfg, tiny_voxelnet_cfg
from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch as TBatch
from robustpointclouds_tpu_torch.models import centerpoint as tcp
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.nn import perturber as tprt
from robustpointclouds_tpu_torch.ops import sparse as tsparse
from robustpointclouds_tpu_torch.tools.convert import jax_to_state_dict
from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer
from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

from test_model import tiny_batch
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

CPU = torch.device("cpu")
TRAIN_KW = dict(warmup_iters=5, max_epochs=2, steps_per_epoch=4)
EPOCH = 5  # the adversary on
# port vs JAX, float32 both sides (tests/test_torch_train.py): losses within
# LOSS_RTOL, each gradient within GRAD_RTOL of its largest entry (GRAD_FLOOR
# of the model's largest for the adversary's BN-fed Linear biases, whose
# true gradient is 0), BN running statistics within rtol 1e-4, atol 1e-5
LOSS_RTOL = 5e-5
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-6
# compact vs padded: the JAX package's bounds for the same comparison
# (tests/test_compact_pert.py) on the losses, total rtol 1e-4 / atol 1e-5,
# each log rtol 2e-4 / atol 1e-5, and on the attack forward's head outputs,
# rtol 2e-3 / atol 2e-5 an entry. The gradients are held per tensor, as
# against JAX above: an entry-wise rtol fails where a gradient entry
# cancels to near 0 (measured: 1.2e-3 apart at an entry of 0.1, in
# conv_input's weight gradient whose largest entry is 55, 2.2e-5 of it).
CP_TOTAL = dict(rtol=1e-4, atol=1e-5)
CP_LOG = dict(rtol=2e-4, atol=1e-5)
CP_OUT = dict(rtol=2e-3, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def float32_mlp():
    import robustpointclouds_tpu.nn.perturber as jprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    yield
    mp.undo()


def _kitti_batch(seed=0):
    return TBatch(*tiny_batch(np.random.RandomState(seed)))


def _nus_batch(cfg, num_points, seed=0):
    return synthetic_nuscenes_batch(np.random.RandomState(seed), batch_size=2,
                                    num_points=num_points, max_gt=cfg.head.max_objs,
                                    num_objects=6, point_range=cfg.voxelizer.point_cloud_range)


def _trainer(family):
    if family == "second":
        return Trainer(tiny_voxelnet_cfg()._replace(compute_dtype="float32"),
                       TrainConfig(**TRAIN_KW), device="cpu")
    if family == "pointpillars":
        return Trainer(tiny_pointpillars_cfg()._replace(compute_dtype="float32"),
                       TrainConfig(**TRAIN_KW), device="cpu")
    cfg, _ = tiny_centerpoint_cfg(tcp.CenterPointConfig(compute_dtype="float32"))
    return CenterPointTrainer(cfg, TrainConfig(learning_rate=5e-5, grad_clip_norm=1.0,
                                               adversary_lr_mult=1.0, **TRAIN_KW), device="cpu")


def _step(family, compact, inline=False, seed=0):
    """(logs, gradients, state_dict) of one train step of a fresh trainer
    (weights from seed 0) at EPOCH, compact or padded, plan-fed or inline."""
    tr = _trainer(family)
    tr.init_state(seed=0)
    mp = pytest.MonkeyPatch()
    mp.setattr(tvn, "COMPACT_PERT", compact)
    try:
        if family == "centerpoint":
            batch, vel = _nus_batch(tr.model_cfg, tiny_centerpoint_cfg(tr.model_cfg)[1], seed)
            plan = None if inline else tr.make_plan_builder()(
                batch.points, batch.points_mask, batch.gt_boxes, batch.gt_labels,
                batch.gt_mask, vel)
            logs = tr.train_step(batch, EPOCH, plan, gt_vel=vel)
        else:
            batch = _kitti_batch(seed)
            plan = None if inline else tr.make_plan_builder()(
                batch.points, batch.points_mask, batch.gt_boxes, batch.gt_labels, batch.gt_mask)
            logs = tr.train_step(batch, EPOCH, plan)
    finally:
        mp.undo()
    grads = {k: p.grad.clone() for k, p in tr.model.named_parameters()}
    return logs, grads, tr.model.state_dict(), tr


def _assert_grads_close(grads, ref):
    """Each gradient within GRAD_RTOL of its reference's largest entry
    (GRAD_FLOOR of the largest of the model where that is smaller)."""
    assert sorted(grads) == sorted(k for k in ref if k in grads) and grads
    gmax = max(np.abs(ref[k].numpy()).max() for k in grads)
    for k, g in grads.items():
        r = ref[k].numpy()
        scale = max(np.abs(r).max(), GRAD_FLOOR * gmax / GRAD_RTOL)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=GRAD_RTOL * scale, err_msg=k)


def _assert_equal(a, b, path):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), path
    else:
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")


@pytest.fixture(scope="module")
def second_jax():
    """JAX's compact step on the tiny SECOND grid: (raw batch, native plan
    with the assignment, initial state dict, grads, new BN stats, logs)."""
    jcfg = j_tiny_voxelnet_cfg()._replace(compute_dtype="float32")
    raw = tiny_batch(np.random.RandomState(0))
    batch = JBatch(*(jnp.asarray(x) for x in raw))
    plan = j_build_plan_native(np.asarray(raw.points), np.asarray(raw.points_mask),
                               jcfg.voxelizer, 4)
    plan["assign"] = jax.tree_util.tree_map(np.asarray, jvn.anchor_assign_plan(
        batch.gt_boxes, batch.gt_labels, batch.gt_mask, jcfg))
    jtr = JTrainer(model_cfg=jcfg, train_cfg=JTrainConfig(**TRAIN_KW))
    state0 = jtr.init_state(jax.random.PRNGKey(0), batch)
    mp = pytest.MonkeyPatch()
    mp.setattr(jvn, "COMPACT_PERT", True)  # read while tracing
    try:
        grads, new_stats, logs, is_nan = jax.jit(jtr._grads)(
            state0, batch, jnp.float32(EPOCH), jax.tree_util.tree_map(jnp.asarray, plan))
    finally:
        mp.undo()
    assert not bool(is_nan)
    return dict(raw=TBatch(*raw), plan=plan,
                sd0=jax_to_state_dict(state0.params, state0.batch_stats),
                grads=jax_to_state_dict(grads, state0.batch_stats),
                stats=jax_to_state_dict(state0.params, new_stats), logs=logs)


def test_second_compact_step_matches_jax(second_jax, monkeypatch):
    s = second_jax
    tr = _trainer("second")
    tr.init_state(state_dict=s["sd0"])
    monkeypatch.setattr(tvn, "COMPACT_PERT", True)
    gt, plan_t = tr._to_device(s["raw"], s["plan"])
    points = tr._points(s["raw"], plan_t)
    assert points[0] is not None  # the plan-fed step hands the points over
    grads, logs, is_nan = tr._grads(gt, float(EPOCH), plan_t, points)
    assert not bool(is_nan)
    assert sorted(logs) == sorted(s["logs"])
    for k, v in s["logs"].items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
    assert float(logs["perturbation_l2_norm"]) > 0
    _assert_grads_close(grads, s["grads"])
    assert sum(float(grads[k].abs().sum()) for k in grads if k.startswith("adversary.")) > 0
    sd = tr.model.state_dict()
    for k, v in s["stats"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("family", ["second", "pointpillars", "centerpoint"])
def test_compact_step_matches_padded(family):
    l0, g0, _, _ = _step(family, compact=False)
    l1, g1, _, _ = _step(family, compact=True)
    assert sorted(l0) == sorted(l1)
    np.testing.assert_allclose(float(l1["loss"]), float(l0["loss"]), **CP_TOTAL)
    for k in l0:
        np.testing.assert_allclose(float(l1[k]), float(l0[k]), **CP_LOG, err_msg=k)
    assert float(l1["perturbation_l2_norm"]) > 0
    _assert_grads_close(g1, g0)
    assert sum(float(g1[k].abs().sum()) for k in g1 if k.startswith("adversary.")) > 0


@pytest.mark.parametrize("family", ["second", "pointpillars", "centerpoint"])
def test_plan_fed_compact_step_equals_inline(family):
    l0, g0, s0, _ = _step(family, compact=True)
    l1, g1, s1, _ = _step(family, compact=True, inline=True)
    _assert_equal(l0, l1, "logs")
    _assert_equal(g0, g1, "grads")
    _assert_equal(dict(s0), dict(s1), "weights")


@pytest.mark.parametrize("family", ["second", "pointpillars", "centerpoint"])
def test_compact_attack_forward_matches_padded(family, monkeypatch):
    tr = _trainer(family)
    tr.init_state(seed=0)
    if family == "centerpoint":
        batch, _ = _nus_batch(tr.model_cfg, tiny_centerpoint_cfg(tr.model_cfg)[1])
    else:
        batch = _kitti_batch()
    plan = tr.make_plan_builder()(batch.points, batch.points_mask)
    outs = []
    for compact in (False, True):
        monkeypatch.setattr(tvn, "COMPACT_PERT", compact)
        outs.append(tr.forward_eval(plan, attack=True, batch=batch))
    (a, b) = outs
    for k in a.adv_aux:
        np.testing.assert_allclose(float(b.adv_aux[k]), float(a.adv_aux[k]), **CP_LOG, err_msg=k)
    assert float(b.adv_aux["l2_norm"]) > 0
    heads = (lambda o: [t for task in o.task_preds for t in task.values()]) if \
        family == "centerpoint" else (lambda o: list(o[:3]))
    for x, y in zip(heads(a), heads(b)):
        np.testing.assert_allclose(y.numpy(), x.numpy(), **CP_OUT)


def test_compact_gather_backward(monkeypatch):
    """d(sum w * voxels_out)/d(points): w at the point's slot for each
    surviving point, 0 for every point voxelisation dropped; the adversary
    of grad_scale 1 and gate 1 (attack) passes the delta's gradient to the
    points through `perturbed - pts` only where they survived."""
    monkeypatch.setattr(tvn, "COMPACT_PERT", True)
    tr = _trainer("second")
    tr.init_state(seed=0)
    batch = _kitti_batch()
    plan = tvn.plan_to_device(tr.make_plan_builder()(batch.points, batch.points_mask), CPU)
    points = torch.from_numpy(np.asarray(batch.points)).float().requires_grad_(True)

    class Double(torch.nn.Module):  # perturbed = 2 * pts: delta = pts
        def forward(self, pts, mask, attack):
            return 2.0 * pts, {"l2_norm": pts.new_zeros(())}

    voxels = plan["voxels"]
    out, _ = tvn.apply_voxel_adversary(Double(), points, voxels, plan, True, 0, 3, 1.0)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    (g,) = torch.autograd.grad((out * w).sum(), points)
    b, v, t, f = voxels.shape
    ps = plan["point_slot"]
    survived = ps < v * t
    assert survived.any() and (~survived & batch_mask(batch)).any()
    assert torch.equal(g[~survived], torch.zeros_like(g[~survived]))
    wf = w.reshape(b, v * t, f)
    for i in range(b):
        keep = survived[i]
        torch.testing.assert_close(g[i, keep, :f], wf[i, ps[i, keep].long()], rtol=0, atol=0)
    # the delta lands in its slot: voxels + delta = 2 * voxels on valid slots
    m = plan["point_mask"][..., None]
    torch.testing.assert_close(torch.where(m, out, 0.0), torch.where(m, 2 * voxels, 0.0),
                               rtol=0, atol=0)



@pytest.mark.parametrize("family", ["second", "pointpillars", "centerpoint"])
def test_reads_points_follows_the_gate_and_missing_points_raise(family, monkeypatch):
    tr = _trainer(family)
    tr.init_state(seed=0)
    if family == "centerpoint":
        batch, _ = _nus_batch(tr.model_cfg, tiny_centerpoint_cfg(tr.model_cfg)[1])
    else:
        batch = _kitti_batch()
    plan = tvn.plan_to_device(tr.make_plan_builder()(batch.points, batch.points_mask), CPU)
    assert not tr.model.reads_points and tr._points(batch, plan) == (None, None)
    monkeypatch.setattr(tvn, "COMPACT_PERT", True)
    assert tr.model.reads_points and tr._points(batch, plan)[0] is not None
    tr.model.eval()
    with torch.no_grad():
        tr.model(None, None, False, 100, False, -1.0, plan)  # clean: no adversary, no points
        with pytest.raises(ValueError, match="RPC_COMPACT_PERT"):
            tr.model(None, None, False, 100, True, -1.0, plan)
        with pytest.raises(ValueError, match="RPC_COMPACT_PERT"):
            tr.forward_eval(plan, attack=True)  # no batch: nothing to hand over
    tr.model.adversary = None
    assert not tr.model.reads_points

def batch_mask(batch):
    return torch.from_numpy(np.asarray(batch.points_mask))


@pytest.mark.parametrize("dtype,c", [(torch.float32, 4), (torch.float32, 5),
                                     (torch.bfloat16, 64), (torch.bfloat16, 3)])
def test_bijective_gather_equals_indexing(dtype, c):
    """ops/sparse.bijective_gather (the compact adversary's slot gather):
    forward and gradient bit-equal to autograd of plain
    indexing into the zero-padded rows, whose backward scatter-adds."""
    gen = torch.Generator().manual_seed(c)
    n, m = 50, 80
    targets = torch.randperm(m, generator=gen)[:35]  # 35 kept rows, each to its own target
    index = torch.full((m,), n, dtype=torch.long)
    index[targets] = torch.arange(35)
    inverse = torch.full((n,), m, dtype=torch.long)
    inverse[:35] = targets
    rows = torch.randn((n, c), generator=gen).to(dtype)
    g = torch.randn((m, c), generator=gen).to(dtype)
    a = rows.clone().requires_grad_(True)
    ref = torch.cat([a, a.new_zeros((1, c))])[index]
    (ga,) = torch.autograd.grad(ref, a, g)
    b = rows.clone().requires_grad_(True)
    out = tsparse.bijective_gather(b, index, inverse)
    (gb,) = torch.autograd.grad(out, b, g)
    assert out.dtype == dtype and torch.equal(out, ref) and torch.equal(gb, ga)
    assert torch.equal(gb[35:], torch.zeros_like(gb[35:]))  # rows without a target
