"""The port's CenterPointTrainer step against the JAX CenterPointTrainer, on the CPU in float32.

Both sides get the same weights (the JAX trainer's initial parameters
through tools/convert.centerpoint_to_state_dict), the same native plan with
the same CenterHead targets, and run in float32 (compute_dtype, PERT_BF16
pinned off, TF32 off) on the --tiny smoke grid at CenterPoint's widths.
One step at epoch 5 (the adversary on, its gradient reversal at
-min(0.05 * 5 / 10, 0.05)) and one at epoch 0 (the adversary gated off):
the loss terms, every parameter gradient, then the parameters and the
BatchNorm running statistics after the optimizer half.

The smoke grid makes the step sensitive to rounding: with its 8 x 8 BEV
cells the train-mode BatchNorms of the dense body normalise over 32-128
values, so one ReLU input that the two sides round to opposite signs moves
some gradient entries by several percent (JAX's own step moves them so
between two compilations). So, as the card-vs-CPU PGD-AT test does: the
dense body's ReLU inputs are compared with JAX's (the same step's
BatchNorm outputs), every unit whose gate differs must lie within BN_BAND
of its BN's scale from zero, and the gradients are compared with the
port's gates set to JAX's at those units.

Measured: one gate differs in each step (epoch 5: a unit of the neck's
second deblock; epoch 0: one of a head's reg branch), losses agree within
1.3e-6 relative and gradients within 2.5e-5 of scale once it is aligned.

Tolerances: losses within LOSS_RTOL relative; each
gradient within GRAD_RTOL of its tensor's largest entry (the adversary's
Linear biases feed train-mode BatchNorms, so their true gradient is 0 and
both sides hold float32 noise: those are held to GRAD_FLOOR of the model's
largest gradient); the updated parameters: Adam moves each by about
lr * sign(g) at its first step, whatever |g|, so where g is float32 noise
on both sides the two updates differ by up to 2 lr; every entry is held to
2 lr (lr = 5e-6, the warm-up's first value) and 99% of them to 0.05 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.cli.train_nuscenes_adversarial import (
    tiny_centerpoint_cfg as jax_tiny_cfg)
from robustpointclouds_tpu.data.nuscenes import synthetic_nuscenes_batch
from robustpointclouds_tpu.data.structures import PointCloudBatch
from robustpointclouds_tpu.models import centerpoint as jcp
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig
from robustpointclouds_tpu.train.centerpoint_loop import CenterPointTrainer as JTrainer

from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
from robustpointclouds_tpu_torch.models import centerpoint as tcp
from robustpointclouds_tpu_torch.models.voxelnet import plan_to_device
from robustpointclouds_tpu_torch.nn.second import BatchNorm2d
from robustpointclouds_tpu_torch.tools.convert import centerpoint_to_state_dict
from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer as TTrainer
from robustpointclouds_tpu_torch.train.loop import TrainConfig as TTrainConfig
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

TRAIN_KW = dict(learning_rate=5e-5, grad_clip_norm=1.0, adversary_lr_mult=1.0, warmup_iters=5,
                max_epochs=2, steps_per_epoch=4)
LOSS_RTOL = 2e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-6
BN_BAND = 1e-5  # a gate may differ only where its input is this close to 0
MAX_FLIPS = 4
_STATS = ("running_mean", "running_var", "num_batches_tracked")


@pytest.fixture(scope="module")
def setup():
    import robustpointclouds_tpu.nn.perturber as jprt
    import robustpointclouds_tpu_torch.nn.perturber as tprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    mp.setenv("RPC_CP_REMAT", "0")
    torch.backends.cudnn.allow_tf32 = False

    jcfg, num_points = jax_tiny_cfg(jcp.CenterPointConfig())
    jcfg = jcfg._replace(compute_dtype="float32")
    tcfg, _ = tiny_centerpoint_cfg(tcp.CenterPointConfig(compute_dtype="float32"))
    raw, vel = synthetic_nuscenes_batch(np.random.RandomState(3), batch_size=2,
                                        num_points=num_points, max_gt=jcfg.head.max_objs,
                                        num_objects=6, point_range=jcfg.voxelizer.point_cloud_range)
    ttr = TTrainer(tcfg, TTrainConfig(**TRAIN_KW), device="cpu")
    plan = ttr.make_plan_builder()(raw.points, raw.points_mask, raw.gt_boxes, raw.gt_labels,
                                   raw.gt_mask, vel)
    batch = PointCloudBatch(*(jnp.asarray(x) for x in raw))
    jtr = JTrainer(model_cfg=jcfg, train_cfg=JTrainConfig(**TRAIN_KW))
    state0 = jtr.init_state(jax.random.PRNGKey(0), batch)
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)
    jgrads = jax.jit(jtr._grads)
    yield dict(raw=raw, vel=jnp.asarray(vel), batch=batch, plan=plan, jplan=jplan, jtr=jtr,
               state0=state0, jgrads=jgrads, japply=jax.jit(jtr._apply), ttr=ttr,
               sd0=centerpoint_to_state_dict(state0.params, state0.batch_stats))
    mp.undo()


def _jax_dense_bn_outputs(s, epoch):
    """The pre-ReLU outputs of the JAX dense body's BatchNorms (backbone,
    neck, head) in the train step's forward, NCHW, keyed by port module name."""
    jtr, st = s["jtr"], s["state0"]

    def fwd(params, plan):
        _, mut = jtr.model.apply(
            {"params": params, "batch_stats": st.batch_stats}, s["batch"].points,
            s["batch"].points_mask, True, jnp.float32(epoch), False, -1.0, plan,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: type(mdl).__name__ == "BatchNorm")
        return mut["intermediates"]

    inter = jax.jit(fwd)(st.params, s["jplan"])
    out = {}
    for s_ in range(2):
        for i in range(6):
            out[f"pts_backbone.blocks.{s_}.{3 * i + 1}"] = \
                inter["pts_backbone"][f"stage{s_}_conv{i}"]["BatchNorm_0"]["__call__"][0]
        out[f"pts_neck.deblocks.{s_}.1"] = inter["pts_neck"][f"deblock{s_}_bn"]["__call__"][0]
    head = inter["pts_bbox_head"]
    out["pts_bbox_head.shared_conv.bn"] = head["shared_bn"]["__call__"][0]
    for t in range(6):
        for name in ("heatmap", "reg", "height", "dim", "rot", "vel"):
            out[f"pts_bbox_head.task_heads.{t}.{name}.0.bn"] = \
                head[f"task{t}_{name}"]["bn0"]["__call__"][0]
    return {k: torch.from_numpy(np.transpose(np.array(v), (0, 3, 1, 2))) for k, v in out.items()}


def _port_grads(s, epoch, flips=None):
    """The port's (grads, logs, is_nan); `flips` {BN module name: bool
    mask}: those units' ReLU inputs negated in value (the gradient passes
    as before), so their gates take the other side. Returns the BN
    outputs (pre-ReLU) too."""
    tr = s["ttr"]
    tr.init_state(state_dict=s["sd0"])
    seen, hooks = {}, []
    for name, mod in tr.model.named_modules():
        if name in (flips or {}) or (flips is None and isinstance(mod, BatchNorm2d)):
            def hook(m, inp, out, name=name):
                seen[name] = out.detach().clone()
                if flips and name in flips:
                    return out + torch.where(flips[name], -2 * out, 0 * out).detach()
            hooks.append(mod.register_forward_hook(hook))
    try:
        return tr._grads(None, float(epoch), plan_to_device(s["plan"], "cpu")), seen
    finally:
        for h in hooks:
            h.remove()


def _both_steps(s, epoch):
    """(port grads, logs, is_nan) with the dense body's gates set to JAX's,
    (JAX grads as port keys, logs, is_nan, raw aux), and the flipped units."""
    tout, bn = _port_grads(s, epoch)
    ref = _jax_dense_bn_outputs(s, epoch)
    assert sorted(ref) == sorted(bn)
    flips = {}
    for k, r in ref.items():
        differ = (r > 0) != (bn[k] > 0)
        if differ.any():
            scale = float(r.abs().max())
            assert float(r[differ].abs().max()) <= BN_BAND * scale, k  # rounding level only
            flips[k] = differ
    assert sum(int(f.sum()) for f in flips.values()) <= MAX_FLIPS, flips.keys()
    if flips:
        tout, _ = _port_grads(s, epoch, flips)
    grads, aux = s["jgrads"](s["state0"], s["batch"], s["vel"], jnp.float32(epoch), s["jplan"])
    jg = centerpoint_to_state_dict(grads, s["state0"].batch_stats)
    return tout, (jg, aux[1], aux[2], (grads, aux)), flips


@pytest.mark.parametrize("epoch", [5, 0])
def test_step_losses_and_gradients_match_jax(setup, epoch):
    (tgrads, tlogs, tnan), (jgrads, jlogs, jnan, _), _ = _both_steps(setup, epoch)
    assert not bool(tnan) and not bool(jnan)
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    assert sorted(tgrads) == sorted(k for k in jgrads if not k.endswith(_STATS))
    gmax = max(np.abs(jgrads[k].numpy()).max() for k in tgrads)
    groups = {}
    for k, g in tgrads.items():
        ref = jgrads[k].numpy()
        scale = max(np.abs(ref).max(), GRAD_FLOOR * gmax / GRAD_RTOL)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=GRAD_RTOL * scale, err_msg=k)
        grp = k.split(".")[0]
        groups[grp] = groups.get(grp, 0.0) + float(g.abs().sum())
    # every module group learns, the adversary only once its gate opens
    for grp in ("pts_middle_encoder", "pts_backbone", "pts_neck", "pts_bbox_head"):
        assert groups[grp] > 0, grp
    assert (groups["adversary"] > 0) == (epoch >= 3)
    if epoch >= 3:
        assert float(tlogs["perturbation_l2_norm"]) > 0


def test_updated_weights_and_statistics_match_jax(setup):
    s = setup
    tr = s["ttr"]
    (tgrads, _, tnan), (_, _, _, (jgrads, aux)), _ = _both_steps(s, 5)
    old = [b.clone() for b in tr._bn_buffers()]
    # the port's forward already moved the running stats; _apply keeps them (no NaN)
    tr._apply(tgrads, tnan, old)
    new_state, _ = s["japply"](s["state0"], jgrads, *aux)
    ref = centerpoint_to_state_dict(new_state.params, new_state.batch_stats)
    sd = tr.model.state_dict()
    lr = tr.det_tx.schedule(0)
    moved, diffs = 0, []
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, r = sd[k].numpy(), r.numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * max(np.abs(r).max(), 1e-6),
                                       err_msg=k)
        else:
            d = np.abs(g - r)
            # 2 lr, plus the float32 rounding of p + update on each side
            assert d.max() <= 2 * lr + 2 * np.spacing(np.abs(r).max()), (k, d.max())
            diffs.append(d.ravel())
            moved += int(not np.array_equal(g, s["sd0"][k].numpy()))
    assert np.quantile(np.concatenate(diffs), 0.99) <= 0.05 * lr
    assert moved > 100  # nearly every parameter tensor took the step
    assert tr.state.step == int(new_state.step) == 1
