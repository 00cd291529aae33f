"""The inline (plan=None) path of the port equals its plan-fed path.

On the CPU, in float32 at the smoke grids: each model family's forward with
no plan (the plan built in torch ops on the points' device) is bitwise equal
to its forward on the native host plan, clean and under attack; one inline
train step of each trainer (the anchor assignment or the CenterPoint targets
computed inside the step) equals the plan-fed step in losses, gradients and
updated weights; export_serving's self-contained `serve(points, mask)`
equals `serve(points, mask, plan)`. The strong family's `forward_eval` with
no plan is held against JAX's inline `forward_eval` on the tiny grid at the
strong tests' tolerance (JAX voxelises it inline; the port read a plan).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.cli.common import tiny_voxelnet_cfg as j_tiny_voxelnet_cfg
from robustpointclouds_tpu.data import synthetic_kitti_batch as j_synthetic_kitti_batch
from robustpointclouds_tpu.data.structures import PointCloudBatch as JBatch
from robustpointclouds_tpu.models.strong import StrongVoxelNetConfig as JStrongCfg
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig
from robustpointclouds_tpu.train.strong_loop import StrongTrainer as JStrongTrainer

from robustpointclouds_tpu_torch.cli.common import tiny_pointpillars_cfg, tiny_voxelnet_cfg
from robustpointclouds_tpu_torch.cli.export import export_serving
from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch, synthetic_kitti_batch
from robustpointclouds_tpu_torch.models import centerpoint as tcp
from robustpointclouds_tpu_torch.models import pointpillars as tpp
from robustpointclouds_tpu_torch.models import strong as tst
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.nn import perturber as tprt
from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig as TVoxelizerConfig
from robustpointclouds_tpu_torch.tools.convert import jax_to_state_dict
from robustpointclouds_tpu_torch.train.centerpoint_loop import (CenterPointPlanBuilder,
                                                                 CenterPointTrainer)
from robustpointclouds_tpu_torch.train.loop import (HostPlanBuilder, PillarPlanBuilder,
                                                    TrainConfig, Trainer)
from robustpointclouds_tpu_torch.train.strong_loop import StrongTrainer
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

CPU = torch.device("cpu")
TRAIN_KW = dict(warmup_iters=5, max_epochs=2, steps_per_epoch=4)
STRONG_PERTURBER = {"sensor_error_bound": 0.18, "hidden_channels": (16, 32),
                    "dropout_rate": 0.0}
# tests/test_torch_strong.py's bound on the head outputs, float32 both sides
HEAD_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def float32_mlp():
    import robustpointclouds_tpu.nn.perturber as jprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    yield
    mp.undo()


def _kitti_batch(seed=0, b=2):
    return synthetic_kitti_batch(np.random.RandomState(seed), batch_size=b, num_points=512,
                                 max_gt=8, num_objects=3,
                                 point_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0))


def _nus_batch(cfg, num_points, seed=0):
    return synthetic_nuscenes_batch(np.random.RandomState(seed), batch_size=2,
                                    num_points=num_points, max_gt=cfg.head.max_objs,
                                    num_objects=6,
                                    point_range=cfg.voxelizer.point_cloud_range)


def _family(name):
    """(model, cfg, host plan builder, batch, gt_vel) of a family at its smoke size."""
    if name == "second":
        cfg = tiny_voxelnet_cfg()._replace(compute_dtype="float32")
        model = tvn.AdversarialVoxelNet(cfg)
        return model, cfg, HostPlanBuilder(cfg), _kitti_batch(), None
    if name == "pointpillars":
        cfg = tiny_pointpillars_cfg()._replace(compute_dtype="float32")
        model = tpp.AdversarialPointPillars(cfg)
        return model, cfg, PillarPlanBuilder(cfg), _kitti_batch(), None
    if name == "centerpoint":
        cfg, n = tiny_centerpoint_cfg(tcp.CenterPointConfig(compute_dtype="float32"))
        model = tcp.AdversarialCenterPoint(cfg)
        batch, vel = _nus_batch(cfg, n)
        return model, cfg, CenterPointPlanBuilder(cfg), batch, vel
    base = tiny_voxelnet_cfg()._replace(adversary=None, compute_dtype="float32")
    cfg = tst.StrongVoxelNetConfig(base=base, perturber=STRONG_PERTURBER)
    model = tst.StrongAdversarialVoxelNet(cfg)
    return model, cfg, HostPlanBuilder(base), _kitti_batch(), None


def _assert_outputs_equal(a, b, path="out"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_outputs_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_outputs_equal(x, y, f"{path}/{i}")
    else:
        assert a == b, path


@pytest.mark.parametrize("mode", ["eval", "attack", "train"])
@pytest.mark.parametrize("family", ["second", "pointpillars", "centerpoint", "strong"])
def test_inline_forward_equals_plan_fed(family, mode):
    model, cfg, build, batch, _ = _family(family)
    tvn.init_weights(model, torch.Generator().manual_seed(0))
    pts, msk = np.asarray(batch.points), np.asarray(batch.points_mask)
    plan = tvn.plan_to_device(build(pts, msk), CPU)
    train, attack = mode == "train", mode == "attack"
    outs = []
    for p, m, pl in ((None, None, plan), (torch.from_numpy(pts), torch.from_numpy(msk), None)):
        state = {k: v.clone() for k, v in model.state_dict().items()}
        with torch.no_grad():
            if family == "strong":
                out = model(p, m, train, 1.3, None, -0.5 if train else 0.0, train or attack,
                            pl, generator=torch.Generator().manual_seed(3))
            else:
                out = model(p, m, train, 5, attack, -1.0, pl)
        outs.append((out, model.state_dict()))
        model.load_state_dict(state)
    _assert_outputs_equal(outs[0][0], outs[1][0])
    _assert_outputs_equal(dict(outs[0][1]), dict(outs[1][1]), "state")  # BN running stats


def test_inline_forward_takes_arrays_and_needs_points():
    model, cfg, build, batch, _ = _family("second")
    tvn.init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model(np.asarray(batch.points), np.asarray(batch.points_mask), False)
        b = model(None, None, False, plan=tvn.plan_to_device(
            build(np.asarray(batch.points), np.asarray(batch.points_mask)), CPU))
    _assert_outputs_equal(a, b)
    with pytest.raises(ValueError, match="needs points"):
        model(None, None, False)


def _trainer(family):
    if family == "second":
        return Trainer(tiny_voxelnet_cfg()._replace(compute_dtype="float32"),
                       TrainConfig(**TRAIN_KW), device="cpu")
    if family == "pointpillars":
        return Trainer(tiny_pointpillars_cfg()._replace(compute_dtype="float32"),
                       TrainConfig(**TRAIN_KW), device="cpu")
    if family == "centerpoint":
        cfg, _ = tiny_centerpoint_cfg(tcp.CenterPointConfig(compute_dtype="float32"))
        return CenterPointTrainer(cfg, TrainConfig(learning_rate=5e-5, grad_clip_norm=1.0,
                                                   adversary_lr_mult=1.0, **TRAIN_KW),
                                  device="cpu")
    base = tiny_voxelnet_cfg()._replace(adversary=None, compute_dtype="float32")
    cfg = tst.StrongVoxelNetConfig(base=base, perturber=STRONG_PERTURBER,
                                   anti_adaptation_prob=0.0)
    return StrongTrainer(cfg, TrainConfig(**TRAIN_KW), device="cpu")


@pytest.mark.parametrize("family", ["second", "pointpillars", "centerpoint", "strong"])
def test_inline_train_step_equals_plan_fed(family):
    """Two steps at epoch 5 (the adversary on): logs, gradients, weights and
    BN statistics bit-equal; the plan-fed side's plan carries the host
    assignment / targets, the inline side computes them in the step."""
    results = []
    for inline in (False, True):
        tr = _trainer(family)
        if family == "strong":
            tr.init_state(seed=0, batch_size=2)
        else:
            tr.init_state(seed=0)
        logs = []
        for step in range(2):
            if family == "centerpoint":
                cfg = tr.model_cfg
                batch, vel = _nus_batch(cfg, tiny_centerpoint_cfg(cfg)[1], seed=step)
                plan = None if inline else tr.make_plan_builder()(
                    batch.points, batch.points_mask, batch.gt_boxes, batch.gt_labels,
                    batch.gt_mask, vel)
                logs.append(tr.train_step(batch, 5, plan, gt_vel=vel))
            else:
                batch = _kitti_batch(seed=step)
                plan = None if inline else tr.make_plan_builder()(
                    batch.points, batch.points_mask, batch.gt_boxes, batch.gt_labels,
                    batch.gt_mask)
                logs.append(tr.train_step(batch, 5, plan))
        grads = {k: p.grad.clone() for k, p in tr.model.named_parameters()}
        results.append((logs, grads, tr.model.state_dict(), tr.state))
    (l0, g0, s0, st0), (l1, g1, s1, st1) = results
    _assert_outputs_equal(l0, l1, "logs")
    _assert_outputs_equal(g0, g1, "grads")
    _assert_outputs_equal(dict(s0), dict(s1), "weights")
    _assert_outputs_equal(st0.mu, st1.mu, "adam mu")
    if family == "strong":
        _assert_outputs_equal(st0.momentum, st1.momentum, "momentum")
    if family in ("second", "pointpillars"):  # the assignment has positives to agree on
        assert sum(float(lg["num_pos"]) for lg in l1) > 0


def test_inline_pgd_at_raises():
    tr = Trainer(tiny_voxelnet_cfg()._replace(compute_dtype="float32"),
                 TrainConfig(pgd_steps=2, **TRAIN_KW), device="cpu")
    tr.init_state(seed=0)
    with pytest.raises(ValueError, match="PGD-AT perturbs the plan's raw voxels"):
        tr.train_step(_kitti_batch(), 5, None)


def test_centerpoint_inline_step_needs_velocities():
    tr = _trainer("centerpoint")
    tr.init_state(seed=0)
    batch, _ = _nus_batch(tr.model_cfg, tiny_centerpoint_cfg(tr.model_cfg)[1])
    with pytest.raises(ValueError, match="gt_vel"):
        tr.train_step(batch, 5, None)


@pytest.mark.parametrize("family", ["second", "pointpillars", "centerpoint"])
def test_self_contained_serve_equals_plan_fed(family):
    model, cfg, build, batch, _ = _family(family)
    tvn.init_weights(model, torch.Generator().manual_seed(0))
    anchors = None if family == "centerpoint" else cfg.make_anchors()[0]
    head = cfg.head._replace(score_thr=0.0)  # random weights score below the 0.1 default
    serve = export_serving(model, None, anchors, head, device="cpu")
    pts, msk = np.asarray(batch.points), np.asarray(batch.points_mask)
    for attack in (False, True):
        got = serve(pts, msk, attack=attack)
        ref = serve(pts, msk, build(pts, msk), attack=attack)
        _assert_outputs_equal(tuple(got), tuple(ref))
        assert bool(got[3].any())  # something survives the NMS


@pytest.fixture(scope="module")
def strong_setup():
    jb = j_tiny_voxelnet_cfg()._replace(adversary=None, compute_dtype="float32")
    jcfg = JStrongCfg(base=jb, perturber=STRONG_PERTURBER, anti_adaptation_prob=0.0)
    jtr = JStrongTrainer(jcfg, JTrainConfig(**TRAIN_KW))
    raw = j_synthetic_kitti_batch(np.random.RandomState(4), batch_size=2, num_points=512,
                                  max_gt=8, num_objects=3,
                                  point_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0))
    jbatch = JBatch(*(jnp.asarray(x) for x in raw))
    state = jtr.init_state(jax.random.PRNGKey(0), jbatch)
    vz = jb.voxelizer
    base = tvn.VoxelNetConfig(
        voxelizer=TVoxelizerConfig(vz.point_cloud_range, vz.voxel_size,
                                   vz.max_points_per_voxel, vz.max_voxels),
        anchor_ranges=jb.anchor_ranges, adversary=None, compute_dtype="float32")
    tr = StrongTrainer(tst.StrongVoxelNetConfig(base=base, perturber=STRONG_PERTURBER,
                                                anti_adaptation_prob=0.0),
                       TrainConfig(**TRAIN_KW), device="cpu")
    tr.init_state(seed=0, state_dict=jax_to_state_dict(state.params, state.batch_stats),
                  batch_size=2)
    mom = np.random.RandomState(1).randn(*state.momentum.shape).astype(np.float32) * 0.02
    state = state._replace(momentum=jnp.asarray(mom), scale_factor=jnp.float32(1.7))
    tr.state.momentum = torch.from_numpy(mom)
    tr.state.scale_factor = torch.tensor(1.7)
    return dict(jtr=jtr, state=state, jbatch=jbatch, tr=tr,
                batch=PointCloudBatch(*(np.asarray(x) for x in raw)))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


@pytest.mark.parametrize("attack", [False, True])
def test_strong_forward_eval_voxelises_inline_as_jax(strong_setup, attack):
    s = strong_setup
    jout = s["jtr"].forward_eval(s["state"], s["jbatch"], attack=attack)
    tout = s["tr"].forward_eval(None, attack=attack, batch=s["batch"])
    for name in ("cls_scores", "bbox_preds", "dir_preds"):
        a, b = getattr(tout, name).numpy(), np.asarray(getattr(jout, name))
        assert a.shape == b.shape and _rel(a, b) <= HEAD_TOL, name
    if attack:
        assert float(np.abs(np.asarray(jout.perturbations)).max()) > 0
        assert _rel(tout.perturbations.numpy(), jout.perturbations) <= HEAD_TOL
    # and the inline port equals its own plan-fed forward_eval bit for bit
    plan = s["tr"].make_plan_builder()(s["batch"].points, s["batch"].points_mask)
    _assert_outputs_equal(tuple(tout), tuple(s["tr"].forward_eval(plan, attack=attack)))
