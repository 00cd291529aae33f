"""The port's adversarial train step against the JAX Trainer, on the CPU in float32.

Both sides get the same weights (the JAX model's initial parameters through
the port's weight bridge), the same native plan with the same anchor
assignment, and run in float32 (JAX's PERT_BF16 pinned off, the port's too,
compute_dtype float32, TF32 off), on the 16 m smoke grid at the real SECOND
and adversary widths. Checked: the loss dict and every parameter gradient
of one step at epoch 5 (adversary on) and epoch 0 (adversary gradients
zero), then parameters and both kinds of BatchNorm running stats after 3
steps, and a NaN step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.cli.common import tiny_voxelnet_cfg
from robustpointclouds_tpu.data.native_plan import build_plan_native
from robustpointclouds_tpu.data.structures import PointCloudBatch
from robustpointclouds_tpu.models import voxelnet as jvn
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig, Trainer as JTrainer

from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch as TBatch
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig as TVoxelizerConfig
from robustpointclouds_tpu_torch.tools.convert import jax_to_state_dict
from robustpointclouds_tpu_torch.train.loop import TrainConfig as TTrainConfig, Trainer as TTrainer

from test_model import tiny_batch
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

TRAIN_KW = dict(warmup_iters=5, max_epochs=2, steps_per_epoch=4)
# float32 on both sides; the losses and gradients differ by summation order
# through 12 sparse convs, 12 dense convs, the BN chain and the losses.
# Measured: losses within 4e-6 relative, every gradient tensor within 1e-4
# of its largest entry; the tolerances leave about 10x margin. The biases
# of the adversary's Linear layers feed a train-mode BatchNorm, so their
# true gradient is 0 and both sides hold float32 noise (~3e-8): those are
# held to GRAD_FLOOR of the largest gradient of the whole model instead.
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-6
LOSS_RTOL = 5e-5


def _port_cfg(jcfg):
    vz = jcfg.voxelizer
    return tvn.VoxelNetConfig(
        voxelizer=TVoxelizerConfig(vz.point_cloud_range, vz.voxel_size,
                                   vz.max_points_per_voxel, vz.max_voxels),
        anchor_ranges=jcfg.anchor_ranges, compute_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    import robustpointclouds_tpu.nn.perturber as jprt
    import robustpointclouds_tpu_torch.nn.perturber as tprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    torch.backends.cudnn.allow_tf32 = False

    jcfg = tiny_voxelnet_cfg()._replace(compute_dtype="float32")
    raw = tiny_batch(np.random.RandomState(0))
    batch = PointCloudBatch(*(jnp.asarray(x) for x in raw))
    plan = build_plan_native(np.asarray(raw.points), np.asarray(raw.points_mask), jcfg.voxelizer, 4)
    plan["assign"] = jax.tree_util.tree_map(np.asarray, jvn.anchor_assign_plan(
        batch.gt_boxes, batch.gt_labels, batch.gt_mask, jcfg))
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)

    jtr = JTrainer(model_cfg=jcfg, train_cfg=JTrainConfig(**TRAIN_KW))
    state0 = jtr.init_state(jax.random.PRNGKey(0), batch)
    jgrads = jax.jit(jtr._grads)
    japply = jax.jit(jtr._apply)

    ttr = TTrainer(_port_cfg(jcfg), TTrainConfig(**TRAIN_KW), device="cpu")
    sd0 = jax_to_state_dict(state0.params, state0.batch_stats)
    yield dict(jcfg=jcfg, raw=TBatch(*raw), batch=batch, plan=plan, jplan=jplan, jtr=jtr,
               state0=state0, jgrads=jgrads, japply=japply, ttr=ttr, sd0=sd0)
    mp.undo()


def _port_grads(s, epoch):
    tr = s["ttr"]
    tr.init_state(state_dict=s["sd0"])
    gt, plan_t = tr._to_device(s["raw"], s["plan"])
    return tr._grads(gt, float(epoch), plan_t)


def _jax_grads_by_key(s, epoch):
    grads, _, logs, is_nan = s["jgrads"](s["state0"], s["batch"], jnp.float32(epoch), s["jplan"])
    return jax_to_state_dict(grads, s["state0"].batch_stats), logs, is_nan


@pytest.mark.parametrize("epoch", [5, 0])
def test_first_step_losses_and_gradients(setup, epoch):
    s = setup
    tgrads, tlogs, tnan = _port_grads(s, epoch)
    jgrads, jlogs, jnan = _jax_grads_by_key(s, epoch)
    assert not bool(tnan) and not bool(jnan)
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
    assert float(jlogs["num_pos"]) > 0  # the detection loss has positives
    assert sorted(tgrads) == sorted(k for k in jgrads if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked")))
    gmax = max(np.abs(jgrads[k].numpy()).max() for k in tgrads)
    for k, g in tgrads.items():
        ref = jgrads[k].numpy()
        scale = max(np.abs(ref).max(), GRAD_FLOOR * gmax / GRAD_RTOL)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=GRAD_RTOL * scale, err_msg=k)
    adv = [k for k in tgrads if k.startswith("adversary.")]
    adv_mass = sum(float(tgrads[k].abs().sum()) for k in adv)
    if epoch >= 3:
        assert adv_mass > 0  # the adversary learns from the detection loss and its terms
        assert float(tlogs["perturbation_l2_norm"]) > 0
    else:
        assert adv_mass == 0.0  # the epoch gate closes every adversary gradient


def test_three_steps_params_and_bn_stats(setup):
    s = setup
    steps, epoch = 3, 5
    state = s["state0"]
    for _ in range(steps):
        state, _ = s["japply"](state, *s["jgrads"](state, s["batch"], jnp.float32(epoch), s["jplan"]))
    ref = jax_to_state_dict(state.params, state.batch_stats)

    tr = s["ttr"]
    tr.init_state(state_dict=s["sd0"])
    for _ in range(steps):
        tr.train_step(s["raw"], epoch, s["plan"])
    got = tr.model.state_dict()
    assert tr.state.step == steps and int(tr.state.nan_count) == 0
    # Adam moves each parameter by about lr * sign(g) a step, whatever |g|:
    # where g is near 0 (float32 noise on both sides) the two updates can
    # differ by up to 2 lr a step. So every entry is held to 2*lr*steps, and
    # the bulk (99% of entries) to 0.05*lr*steps.
    lr = TTrainConfig(**TRAIN_KW).learning_rate
    diffs = []
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = np.abs(v.numpy() - ref[k].numpy())
        if k.endswith(("running_mean", "running_var")):
            # BN running stats: the same batch statistics on both sides
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
        else:
            assert d.max() <= 2 * lr * steps, (k, d.max())
            diffs.append(d.ravel())
    diffs = np.concatenate(diffs)
    assert np.quantile(diffs, 0.99) <= 0.05 * lr * steps
    # and the parameters did move, detector and adversary both
    for k in ("middle_encoder.conv_input.0.weight", "adversary.mlp_0.weight"):
        assert not torch.equal(got[k], s["sd0"][k])


def test_nan_step_freezes_params_and_stats(setup):
    s = setup
    tr = s["ttr"]
    tr.init_state(state_dict=s["sd0"])
    plan = dict(s["plan"])
    plan["voxels"] = np.full_like(plan["voxels"], np.nan)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    logs = tr.train_step(s["raw"], 5, plan)
    assert not np.isfinite(float(logs["loss"]))
    after = tr.model.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    st = tr.state
    assert (st.step, st.count, int(st.nan_count), int(st.consecutive_nan)) == (1, 1, 1, 1)
    assert float(st.lr_scale) == 1.0 and float(st.adversary_enabled) == 1.0
    # the Adam moments advanced on the sanitised (finite) gradients
    assert all(torch.isfinite(m).all() for m in st.mu.values())


def test_forward_eval_is_the_eval_mode_forward(setup):
    s = setup
    tr = s["ttr"]
    tr.init_state(state_dict=s["sd0"])
    outs = tr.forward_eval(s["plan"], attack=True)
    assert not tr.model.training
    with torch.no_grad():
        ref = tr.model(None, None, False, 100, True, -1.0,
                       tvn.plan_to_device(s["plan"], torch.device("cpu")))
    for a, b in zip(outs[:3], ref[:3]):
        assert torch.equal(a, b)
    assert float(outs.adv_aux["l2_norm"]) > 0  # attack=True ran the adversary
    # eval mode leaves the BatchNorm running stats as they were
    for k, v in tr.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, s["sd0"][k]), k
