"""The port's PointPillars family against the JAX package, on the CPU in float32.

Both sides get the same weights (the JAX model's initial parameters with
randomised BatchNorm statistics and affine parameters, through
tools/convert.pointpillars_to_state_dict), the same native pillar plan and
anchor assignment, and run in float32 (compute_dtype, PERT_BF16 pinned off
on both sides, TF32 off) on tests/test_pointpillars.py's tiny setup: a
32 x 32 pillar grid, 128 pillars x 8 points, B=2, adversary (8, 16, 8).
Checked:
  * the native pillar plan bit-equal to JAX's native plan and to JAX's
    jitted models/pointpillars.build_pillar_plan;
  * the port's BEV scatter_to_dense equal to JAX's scatter_to_dense_gather
    through the plan's dense-cell map, forward and backward, and that map
    equal to JAX's dense_gather_map;
  * PillarFeatureNet in train and eval mode, and its running statistics
    after one train call (flax momentum 0.99): rtol FWD_RTOL of scale;
  * the whole forward (eval, train at epoch 5, attack=True), its adversary
    terms and the running statistics after the train forward;
  * one Trainer step's losses and gradients against JAX Trainer._grads,
    the dense body's rounding-level ReLU gates aligned first (as
    tests/test_torch_centerpoint_train.py does), then GRAD_RTOL of scale;
  * PGD-2 on a pillar plan against JAX's make_plan_attack.
Measured: the PFN and the eval and attack forwards within 8e-7 of scale,
the train forward within 1.8e-5 (TRAIN_FWD_RTOL says why), the step's
losses within 4.3e-7 relative and its gradients within 5.5e-5 of scale
(the PFN's Linear) with no dense-body gate differing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.data.native_plan import build_pillar_plan_native as j_native_plan
from robustpointclouds_tpu.data.structures import PointCloudBatch as JBatch
from robustpointclouds_tpu.eval.attacks import make_plan_attack as j_make_plan_attack
from robustpointclouds_tpu.models import pointpillars as jpp
from robustpointclouds_tpu.models import voxelnet as jvn
from robustpointclouds_tpu.models.detection import anchor_head_loss as j_anchor_head_loss
from robustpointclouds_tpu.nn.perturber import _bound_profile
from robustpointclouds_tpu.ops import sparse as jsparse
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig, Trainer as JTrainer

from robustpointclouds_tpu_torch.cli.common import run_evaluation
from robustpointclouds_tpu_torch.cli.export import export_serving
from robustpointclouds_tpu_torch.data.native_plan import build_pillar_plan_native
from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch as TBatch
from robustpointclouds_tpu_torch.eval.attacks import frozen, make_plan_attack
from robustpointclouds_tpu_torch.models import pointpillars as tpp
from robustpointclouds_tpu_torch.models.voxelnet import plan_to_device
from robustpointclouds_tpu_torch.nn.second import BatchNorm2d
from robustpointclouds_tpu_torch.ops import sparse as tsparse
from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig as TVoxelizerConfig
from robustpointclouds_tpu_torch.tools.convert import pointpillars_to_state_dict
from robustpointclouds_tpu_torch.train.loop import (PillarPlanBuilder, TrainConfig as TTrainConfig,
                                                    Trainer as TTrainer)

from test_pointpillars import tiny_batch, tiny_pp_cfg
from test_torch_serving import _randomise_bn
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

TRAIN_KW = dict(warmup_iters=5, max_epochs=2, steps_per_epoch=4)
# float32 on both sides, summation order only
FWD_RTOL = 1e-5
# the train-mode forward: the backbone's last stage normalises each channel
# over 2 x 4 x 4 = 32 values with batch statistics, which lifts the
# summation-order error from ~2e-6 of scale (stage 0) to ~2e-5 at its BNs
# and 1.1-1.8e-5 at the head, with no ReLU gate differing (measured with
# the initial and the randomised BN parameters)
TRAIN_FWD_RTOL = 5e-5
LOSS_RTOL = 2e-5
# gradients, once the rounding-level ReLU gates agree: summation order
# through the PFN, 16 backbone convs, the neck, the head and the losses
GRAD_RTOL = 1e-4
# the adversary's Linear biases feed train-mode BatchNorms: their true
# gradient is 0 and both sides hold float32 noise, held to this share of
# the model's largest gradient
GRAD_FLOOR = 1e-6
BN_BAND = 1e-5  # a gate may differ only where its input is this close to 0
MAX_FLIPS = 4
GRAD_STEP_RTOL = 1e-4  # the attack's first gradient
ATTACK_AGREE = 0.99  # a sign(g) flips where |g| is at rounding level
_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _port_cfg(jcfg):
    vz = jcfg.voxelizer
    return tpp.PointPillarsConfig(
        voxelizer=TVoxelizerConfig(vz.point_cloud_range, vz.voxel_size,
                                   vz.max_points_per_voxel, vz.max_voxels),
        anchor_ranges=jcfg.anchor_ranges, adversary=jcfg.adversary,
        adversarial_loss_weight=jcfg.adversarial_loss_weight, compute_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    import robustpointclouds_tpu.nn.perturber as jprt
    import robustpointclouds_tpu_torch.nn.perturber as tprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    torch.backends.cudnn.allow_tf32 = False

    jcfg = tiny_pp_cfg()._replace(compute_dtype="float32")
    rng = np.random.RandomState(2)
    batch = tiny_batch(rng)
    raw = TBatch(*(np.asarray(x) for x in batch))
    jtr = JTrainer(model_cfg=jcfg, train_cfg=JTrainConfig(**TRAIN_KW))
    state0 = jtr.init_state(jax.random.PRNGKey(0), batch)
    params = _randomise_bn(dict(state0.params), rng)
    stats = _randomise_bn(dict(state0.batch_stats), rng)
    state = state0._replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    ttr = TTrainer(_port_cfg(jcfg), TTrainConfig(**TRAIN_KW), device="cpu")
    plan = ttr.make_plan_builder()(raw.points, raw.points_mask, raw.gt_boxes, raw.gt_labels,
                                   raw.gt_mask)
    jassign = jax.tree_util.tree_map(np.asarray, jvn.anchor_assign_plan(
        batch.gt_boxes, batch.gt_labels, batch.gt_mask, jcfg))
    jplan = jax.tree_util.tree_map(jnp.asarray, dict(plan, assign=jassign))
    yield dict(jcfg=jcfg, raw=raw, batch=batch, jtr=jtr, state=state, ttr=ttr, plan=plan,
               jplan=jplan, jassign=jassign, state0=state0,
               sd=pointpillars_to_state_dict(state.params, state.batch_stats),
               sd0=pointpillars_to_state_dict(state0.params, state0.batch_stats))
    mp.undo()


def _close(got, ref, rtol, what):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


def _port_model(s, train):
    tr = s["ttr"]
    tr.init_state(state_dict=s["sd"])
    tr.model.train(train)
    return tr.model


def test_port_smoke_config_is_the_tiny_setup(setup):
    from robustpointclouds_tpu_torch.cli.common import tiny_pointpillars_cfg

    assert tiny_pointpillars_cfg()._replace(compute_dtype="float32") == setup["ttr"].model_cfg


def test_native_pillar_plan_bit_equal_to_jax(setup):
    s = setup
    raw, vz = s["raw"], s["jcfg"].voxelizer
    got = build_pillar_plan_native(raw.points, raw.points_mask, s["ttr"].model_cfg.voxelizer)
    assert set(got) == {"voxels", "vox_coords", "num_points", "voxel_mask", "point_mask",
                        "slot_point", "point_slot", "order", "grid_ids", "grid_coords",
                        "grid_mask", "dense"}
    native = j_native_plan(raw.points, raw.points_mask, vz)
    jitted = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p, m: jpp.build_pillar_plan(p, m, s["jcfg"]))(jnp.asarray(raw.points),
                                                             jnp.asarray(raw.points_mask)))
    for ref in (native, jitted):
        assert set(ref) == set(got)
        for k, v in got.items():
            assert v.dtype == np.asarray(ref[k]).dtype, k
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
    assert got["voxel_mask"].sum() > 0
    # the builder's plan: the same arrays plus the anchor assignment, bit-equal to JAX's
    for k, v in s["jassign"].items():
        np.testing.assert_array_equal(s["plan"]["assign"][k], v, err_msg=k)


def test_scatter_to_dense_gather_equals_scatter(setup):
    """The port densifies the BEV grid with scatter_to_dense, as for SECOND;
    JAX's pillar model gathers through the plan's dense-cell map, because
    the TPU serialises scatters. Both agree bit for bit, both ways."""
    plan = plan_to_device(setup["plan"], "cpu")
    nx, ny, _ = setup["ttr"].model_cfg.voxelizer.grid_size
    grid = tsparse.SparseGrid(plan["grid_ids"], plan["grid_coords"], plan["grid_mask"],
                              (2, ny, nx))
    jgrid = jsparse.SparseGrid(*(jnp.asarray(setup["plan"][k])
                                 for k in ("grid_ids", "grid_coords", "grid_mask")), (2, ny, nx))
    np.testing.assert_array_equal(np.asarray(jsparse.dense_gather_map(jgrid)),
                                  setup["plan"]["dense"])
    rng = np.random.RandomState(0)
    feats = rng.standard_normal((grid.flat_ids.shape[0], 8)).astype(np.float32)
    g = rng.standard_normal((2, ny, nx, 8)).astype(np.float32)
    x = torch.from_numpy(feats).requires_grad_(True)
    dense = tsparse.scatter_to_dense(x, grid)
    dense.backward(torch.from_numpy(g))
    dmap = jnp.asarray(setup["plan"]["dense"])
    ref, vjp = jax.vjp(lambda f: jsparse.scatter_to_dense_gather(f, jgrid, dmap),
                       jnp.asarray(feats))
    np.testing.assert_array_equal(dense.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    assert dense.abs().sum() > 0 and (x.grad[~grid.mask] == 0).all()


@pytest.mark.parametrize("train", [True, False])
def test_pillar_feature_net_matches_jax(setup, train):
    s = setup
    plan = s["plan"]
    jcfg = s["jcfg"]
    vx, vy, _ = jcfg.voxelizer.voxel_size
    pcr = jcfg.voxelizer.point_cloud_range
    jpfn = jpp.PillarFeatureNet(out_channels=64, voxel_size=(vx, vy), pc_start=pcr[:2])
    variables = {"params": s["state"].params["pfn"], "batch_stats": s["state"].batch_stats["pfn"]}
    ref, mut = jpfn.apply(variables, jnp.asarray(plan["voxels"]), jnp.asarray(plan["point_mask"]),
                          jnp.asarray(plan["vox_coords"]), train, mutable=["batch_stats"])
    pfn = _port_model(s, train).voxel_encoder
    t = plan_to_device(plan, "cpu")
    with torch.no_grad():
        got = pfn(t["voxels"], t["point_mask"], t["vox_coords"])
    _close(got.numpy(), ref, FWD_RTOL, "pfn out")
    assert (got[~t["voxel_mask"]] == 0).all() and got.abs().sum() > 0
    norm = pfn.pfn_layers[0].norm
    new = mut["batch_stats"]["MaskedBatchNorm_0"]
    _close(norm.running_mean.numpy(), new["mean"], FWD_RTOL, "running_mean")
    _close(norm.running_var.numpy(), new["var"], FWD_RTOL, "running_var")
    old = s["state"].batch_stats["pfn"]["MaskedBatchNorm_0"]["mean"]
    assert np.array_equal(np.asarray(old), norm.running_mean.numpy()) != train


@pytest.mark.parametrize("mode", ["eval", "train", "attack"])
def test_forward_matches_jax(setup, mode):
    s = setup
    train, epoch, attack = {"eval": (False, 100, False), "train": (True, 5, False),
                            "attack": (False, 100, True)}[mode]
    st = s["state"]
    ref, mut = s["jtr"].model.apply(
        {"params": st.params, "batch_stats": st.batch_stats}, s["batch"].points,
        s["batch"].points_mask, train, jnp.float32(epoch), attack, -1.0, s["jplan"],
        mutable=["batch_stats"])
    model = _port_model(s, train)
    with torch.no_grad():
        got = model(None, None, train, float(epoch), attack, -1.0, plan_to_device(s["plan"], "cpu"))
    rtol = TRAIN_FWD_RTOL if train else FWD_RTOL
    for name in ("cls_scores", "bbox_preds", "dir_preds"):
        _close(getattr(got, name).numpy(), getattr(ref, name), rtol, name)
    assert sorted(got.adv_aux) == sorted(ref.adv_aux)
    for k, v in ref.adv_aux.items():
        np.testing.assert_allclose(float(got.adv_aux[k]), float(v), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    assert (float(got.adv_aux["l2_norm"]) > 0) == (mode != "eval")
    new_sd = pointpillars_to_state_dict(st.params, mut["batch_stats"])
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(v.numpy(), new_sd[k].numpy(), FWD_RTOL, k)


def _jax_dense_bn_outputs(s, epoch):
    """The pre-ReLU outputs of the JAX backbone's and neck's BatchNorms in
    the train forward, NCHW, keyed by the port's module names."""
    st = s["state"]

    def fwd(params, plan):
        _, mut = s["jtr"].model.apply(
            {"params": params, "batch_stats": st.batch_stats}, s["batch"].points,
            s["batch"].points_mask, True, jnp.float32(epoch), False, -1.0, plan,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: type(mdl).__name__ == "BatchNorm")
        return mut["intermediates"]

    inter = jax.jit(fwd)(st.params, s["jplan"])
    out = {}
    for stage, n in enumerate(s["jcfg"].backbone_layers):
        for i in range(n + 1):
            out[f"backbone.blocks.{stage}.{3 * i + 1}"] = \
                inter["backbone"][f"stage{stage}_conv{i}"]["BatchNorm_0"]["__call__"][0]
    for i in range(len(s["jcfg"].fpn_strides)):
        out[f"neck.deblocks.{i}.1"] = inter["neck"][f"deblock{i}_bn"]["__call__"][0]
    return {k: torch.from_numpy(np.transpose(np.array(v), (0, 3, 1, 2))) for k, v in out.items()}


def _port_grads(s, epoch, flips=None):
    """The port's (grads, logs, is_nan) and its dense-body BN outputs;
    `flips` {module name: bool mask} negates those ReLU inputs in value
    (the gradient passes as before), so their gates take the other side."""
    tr = s["ttr"]
    tr.init_state(state_dict=s["sd"])
    seen, hooks = {}, []
    for name, mod in tr.model.named_modules():
        if isinstance(mod, BatchNorm2d):
            def hook(m, inp, out, name=name):
                seen[name] = out.detach().clone()
                if flips and name in flips:
                    return out + torch.where(flips[name], -2 * out, 0 * out).detach()
            hooks.append(mod.register_forward_hook(hook))
    try:
        gt, plan_t = tr._to_device(s["raw"], s["plan"])
        return tr._grads(gt, float(epoch), plan_t), seen
    finally:
        for h in hooks:
            h.remove()


def test_train_step_losses_and_gradients_match_jax(setup):
    s = setup
    epoch = 5
    (tgrads, tlogs, tnan), bn = _port_grads(s, epoch)
    ref = _jax_dense_bn_outputs(s, epoch)
    assert sorted(ref) == sorted(bn)
    flips = {}
    for k, r in ref.items():
        differ = (r > 0) != (bn[k] > 0)
        if differ.any():
            assert float(r[differ].abs().max()) <= BN_BAND * float(r.abs().max()), k
            flips[k] = differ
    assert sum(int(f.sum()) for f in flips.values()) <= MAX_FLIPS, flips.keys()
    if flips:
        (tgrads, tlogs, tnan), _ = _port_grads(s, epoch, flips)
    grads, _, jlogs, jnan = jax.jit(s["jtr"]._grads)(s["state"], s["batch"], jnp.float32(epoch),
                                                      s["jplan"])
    jgrads = pointpillars_to_state_dict(grads, s["state"].batch_stats)
    assert not bool(tnan) and not bool(jnan)
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    assert float(jlogs["num_pos"]) > 0 and float(tlogs["perturbation_l2_norm"]) > 0
    assert sorted(tgrads) == sorted(k for k in jgrads if not k.endswith(_STATS))
    gmax = max(np.abs(jgrads[k].numpy()).max() for k in tgrads)
    groups = {}
    for k, g in tgrads.items():
        r = jgrads[k].numpy()
        scale = max(np.abs(r).max(), GRAD_FLOOR * gmax / GRAD_RTOL)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=GRAD_RTOL * scale, err_msg=k)
        groups[k.split(".")[0]] = groups.get(k.split(".")[0], 0.0) + float(g.abs().sum())
    for grp in ("voxel_encoder", "backbone", "neck", "bbox_head", "adversary"):
        assert groups[grp] > 0, grp


def test_plan_attack_matches_jax(setup):
    s = setup
    st, jtr, jcfg, raw = s["state"], s["jtr"], s["jcfg"], s["raw"]
    plan = {k: v for k, v in s["plan"].items() if k != "assign"}
    jb = JBatch(*(jnp.asarray(x) for x in raw))
    ref_attacked = np.asarray(j_make_plan_attack(jtr, steps=2)(
        st.params, st.batch_stats, jb, plan)["voxels"])
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)

    def det_loss(delta):  # eval/attacks.py's loss at the first step
        m = jplan["point_mask"][..., None].astype(jnp.float32)
        outs = jtr.model.apply({"params": st.params, "batch_stats": st.batch_stats},
                               jb.points, jb.points_mask, False, 100, False, -1.0,
                               dict(jplan, voxels=jplan["voxels"] + delta * m))
        det = j_anchor_head_loss(outs.cls_scores, outs.bbox_preds, outs.dir_preds,
                                 jtr.anchors, jtr.anchor_cls, jb.gt_boxes, jb.gt_labels,
                                 jb.gt_mask, jcfg.head)
        return det["loss_cls"] + det["loss_bbox"] + det["loss_dir"]

    ref_g = np.asarray(jax.jit(jax.grad(det_loss))(jnp.zeros_like(jplan["voxels"])))
    tr = s["ttr"]
    tr.init_state(state_dict=s["sd"])
    attack = make_plan_attack(tr, steps=2)
    gt, plan_t = attack.prepare(raw, plan)
    with frozen(tr.model):
        g = attack.loss_grad(torch.zeros_like(plan_t["voxels"]), gt, plan_t).numpy()
    assert np.abs(ref_g).max() > 0
    _close(g, ref_g, GRAD_STEP_RTOL, "first attack gradient")
    got = attack(raw, plan)["voxels"].numpy()
    _, clamp = _bound_profile(4, 0.2, attack=True)
    assert (got == ref_attacked).mean() >= ATTACK_AGREE
    assert (np.abs(got - ref_attacked) <= 2 * (2.5 * clamp / 2) + 1e-5).all()
    pm = plan["point_mask"].astype(bool)
    np.testing.assert_array_equal(got[~pm], plan["voxels"][~pm])  # padding untouched
    assert all(p.requires_grad for p in tr.model.parameters())


def test_trainer_serving_and_evaluation_run_the_pillar_family(setup):
    s = setup
    tr = s["ttr"]
    assert isinstance(tr.model, tpp.AdversarialPointPillars)
    builder = tr.make_plan_builder()
    assert isinstance(builder, PillarPlanBuilder)
    raw = s["raw"]
    plan = builder(raw.points, raw.points_mask)
    assert "assign" not in plan and "dense" in plan and "enc" not in plan
    assert set(builder.timings[-1]) == {"native_ms", "assign_ms", "plan_ms"}
    # the inline path (plan=None) builds the plan from the points, which it needs
    with pytest.raises(ValueError, match="needs points"):
        tr.model(None, None, False, 100, False, -1.0, None)
    with torch.no_grad():
        inline = tr.model(torch.from_numpy(np.asarray(raw.points)),
                          torch.from_numpy(np.asarray(raw.points_mask)), False, 100)
        fed = tr.model(None, None, False, 100, False, -1.0, plan_to_device(plan, "cpu"))
    assert torch.equal(inline.cls_scores, fed.cls_scores)
    # serving: anchor decode + rotated NMS on the pillar plan
    cfg = tr.model_cfg
    serve = export_serving(tpp.AdversarialPointPillars(cfg), s["sd"], cfg.make_anchors()[0],
                           cfg.head, device="cpu")
    for attack in (False, True):
        boxes, scores, labels, valid = serve(None, None, plan, attack=attack)
        assert boxes.shape == (2, cfg.head.max_num, 7) and torch.isfinite(boxes).all()
    # evaluation: clean, learned and PGD through run_evaluation
    tr.init_state(state_dict=s["sd"])
    for kw in ({}, dict(attack=True), dict(attack=True, attack_method="pgd", attack_steps=2)):
        timings = {}
        res = run_evaluation(tr, [raw], timings=timings, **kw)
        assert res["num_frames"] == 2 and np.isfinite(res["mAP_3d_moderate"])
        assert len(timings["batches"]) == 1
