"""The port's PGD adversarial training and freeze-detector mode against the JAX Trainer, on the CPU in float32.

Both sides get the same weights (the JAX model's initial parameters through
the port's weight bridge), the same native plan with its anchor assignment,
and run in float32 (PERT_BF16 pinned off on both sides, compute_dtype
float32). PGD-AT runs on the setup of tests/test_attacks.py's PGD-AT test
(the tiny grid without the adversary, loosened IoU thresholds, two frames
of six separated cars), at pgd_steps=2. Checked:
  * `_maybe_pgd`: the attacked voxels equal JAX's on >= 99% of entries and
    within 2 alpha elsewhere (a sign(g) flips where |g| is at rounding
    level, the rule of tests/test_torch_eval.py), padding untouched; the
    attack leaves the BN running stats and every requires_grad as found;
  * the PGD-AT step: the port's gradient step on JAX's attacked plan holds
    the params and BN stats after the step to JAX's `_step_impl` (its
    `_apply(_grads(_maybe_pgd(...)))`) at the tolerances of
    tests/test_torch_train.py; the port's own `train_step` with pgd_steps=2
    is exactly its plain step on its own attacked plan, and launches the
    sparse conv's forward 12*(K+1), dgrad 12*K + 11 and wgrad 12 times;
  * `plan=None` raises;
  * freeze mode, 3 steps on test_torch_train's setup (the adversary at its
    real widths, the CLI's freeze overrides): the detector's params are
    bit-unchanged, the adversary's params and every BN stat are held to
    JAX's, and the Adam count advances.
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
from robustpointclouds_tpu.nn.perturber import _bound_profile
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig, Trainer as JTrainer

import robustpointclouds_tpu_torch.kernels.sparse_conv as tsc
from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch as TBatch
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig as TVoxelizerConfig
from robustpointclouds_tpu_torch.tools.convert import jax_to_state_dict
from robustpointclouds_tpu_torch.train.loop import TrainConfig as TTrainConfig, Trainer as TTrainer

from test_attack_quantified import separated_car_batch
from test_model import tiny_batch, tiny_cfg
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

K = 2
EPOCH = 5
LR = 1e-4
# the attack rule of tests/test_torch_eval.py
ATTACK_AGREE = 0.99
# tests/test_torch_train.py's tolerances after a step: every parameter entry
# within 2*lr*steps (Adam moves an entry by ~lr*sign(g) a step, whatever |g|),
# 99% of entries within 0.05*lr*steps, BN running stats rtol 1e-4 atol 1e-5
BN_RTOL, BN_ATOL = 1e-4, 1e-5
FREEZE = dict(adversary_lr_mult=20.0, adversarial_loss_weight=0.5, regularization_weight=1e-5,
              freeze_detector=True)
TRAIN_KW = dict(warmup_iters=5, max_epochs=2, steps_per_epoch=4)


def _port_cfg(jcfg):
    vz = jcfg.voxelizer
    return tvn.VoxelNetConfig(
        voxelizer=TVoxelizerConfig(vz.point_cloud_range, vz.voxel_size, vz.max_points_per_voxel,
                                   vz.max_voxels),
        anchor_ranges=jcfg.anchor_ranges, head=jcfg.head, adversary=jcfg.adversary,
        adversary_start_epoch=jcfg.adversary_start_epoch, compute_dtype="float32")


@pytest.fixture(scope="module")
def pinned():
    import robustpointclouds_tpu.nn.perturber as jprt
    import robustpointclouds_tpu_torch.nn.perturber as tprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    yield
    mp.undo()


def _plan(jcfg, raw):
    plan = build_plan_native(np.asarray(raw.points), np.asarray(raw.points_mask), jcfg.voxelizer, 4)
    batch = PointCloudBatch(*(jnp.asarray(x) for x in raw))
    plan["assign"] = jax.tree_util.tree_map(np.asarray, jvn.anchor_assign_plan(
        batch.gt_boxes, batch.gt_labels, batch.gt_mask, jcfg))
    return batch, plan


@pytest.fixture(scope="module")
def pgd(pinned):
    jcfg = tiny_cfg(adversary=False)
    jcfg = jcfg._replace(compute_dtype="float32", head=jcfg.head._replace(
        pos_iou_thr=(0.25, 0.1, 0.1), neg_iou_thr=(0.15, 0.05, 0.05),
        min_pos_iou=(0.1, 0.05, 0.05)))
    raw = separated_car_batch(np.random.RandomState(5))
    batch, plan = _plan(jcfg, raw)
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)
    jtr = JTrainer(model_cfg=jcfg, train_cfg=JTrainConfig(learning_rate=LR, pgd_steps=K))
    state = jtr.init_state(jax.random.PRNGKey(0), batch)
    attacked = jax.jit(jtr._maybe_pgd)(state, batch, jplan)
    new_state, _ = jax.jit(jtr._apply)(state, *jax.jit(jtr._grads)(state, batch, jnp.float32(EPOCH),
                                                                     attacked))
    yield dict(jcfg=jcfg, raw=TBatch(*raw), plan=plan, batch=batch, jtr=jtr, state=state,
               sd0=jax_to_state_dict(state.params, state.batch_stats),
               attacked=jax.tree_util.tree_map(np.asarray, attacked),
               ref=jax_to_state_dict(new_state.params, new_state.batch_stats))


def _port_trainer(s, **train_kw):
    tr = TTrainer(_port_cfg(s["jcfg"]), TTrainConfig(learning_rate=LR, **train_kw), device="cpu")
    tr.init_state(state_dict=s["sd0"])
    return tr


def test_maybe_pgd_matches_jax(pgd):
    s = pgd
    tr = _port_trainer(s, pgd_steps=K)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    _, plan_t = tr._to_device(s["raw"], s["plan"])
    got = tr._maybe_pgd(s["raw"], plan_t)["voxels"].numpy()
    ref = s["attacked"]["voxels"]
    _, clamp = _bound_profile(4, 0.2, attack=True)
    alpha = 2.5 * clamp / K
    assert (got == ref).mean() >= ATTACK_AGREE, (got == ref).mean()
    assert (np.abs(got - ref) <= 2 * alpha + 1e-5).all()
    pm = s["plan"]["point_mask"].astype(bool)
    assert np.abs(got - s["plan"]["voxels"])[pm].max() > 0  # the attack moved the valid slots
    np.testing.assert_array_equal(got[~pm], s["plan"]["voxels"][~pm])
    for k, v in tr.model.state_dict().items():  # BN running stats (and weights) as found
        assert torch.equal(v, before[k]), k
    assert all(p.requires_grad for p in tr.model.parameters())


def test_pgd_needs_a_plan(pgd):
    tr = _port_trainer(pgd, pgd_steps=K)
    with pytest.raises(ValueError, match="plan"):
        tr._maybe_pgd(pgd["raw"], None)
    plain = _port_trainer(pgd)
    assert plain._maybe_pgd(pgd["raw"], None) is None  # no PGD: the plan passes through


def _held_to(got, ref, lr, steps, keys):
    diffs = []
    for k in keys:
        g, r = got[k].numpy(), ref[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, r, rtol=BN_RTOL, atol=BN_ATOL, err_msg=k)
        else:
            d = np.abs(g - r)
            assert d.max() <= 2 * lr * steps, (k, d.max())
            diffs.append(d.ravel())
    if diffs:
        assert np.quantile(np.concatenate(diffs), 0.99) <= 0.05 * lr * steps


def test_pgd_step_on_jax_attacked_plan_matches_jax(pgd):
    s = pgd
    tr = _port_trainer(s)
    plan = dict(s["plan"], voxels=s["attacked"]["voxels"])
    logs = tr.train_step(s["raw"], EPOCH, plan)
    assert float(logs["num_pos"]) > 0 and np.isfinite(float(logs["loss"]))
    got = tr.model.state_dict()
    keys = [k for k in got if not k.endswith("num_batches_tracked")]
    _held_to(got, s["ref"], LR, 1, keys)
    assert not torch.equal(got["middle_encoder.conv_input.0.weight"],
                           s["sd0"]["middle_encoder.conv_input.0.weight"])


def test_pgd_train_step_is_the_plain_step_on_its_attack(pgd, monkeypatch):
    s = pgd
    at = _port_trainer(s, pgd_steps=K)
    _, plan_t = at._to_device(s["raw"], s["plan"])
    attacked = at._maybe_pgd(s["raw"], plan_t)
    plain = _port_trainer(s)
    plain.train_step(s["raw"], EPOCH, dict(s["plan"], voxels=attacked["voxels"].numpy()))

    calls = {"sparse_conv": 0, "sparse_conv_dgrad": 0, "sparse_conv_wgrad": 0}
    for name in calls:
        def counted(*a, _fn=getattr(tsc, name), _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(tsc, name, counted)
    at = _port_trainer(s, pgd_steps=K)
    at.train_step(s["raw"], EPOCH, s["plan"])
    # K attack steps (forward + input gradient of all 12 convs, no weight
    # gradient), then the train step: no adversary, so conv_input's input
    # needs no gradient (11 dgrads) and every conv's weight does
    assert calls == {"sparse_conv": 12 * (K + 1), "sparse_conv_dgrad": 12 * K + 11,
                     "sparse_conv_wgrad": 12}
    for k, v in plain.model.state_dict().items():
        assert torch.equal(at.model.state_dict()[k], v), k
    assert all(p.requires_grad for p in at.model.parameters())


@pytest.fixture(scope="module")
def freeze(pinned):
    jcfg = tiny_voxelnet_cfg()._replace(compute_dtype="float32", adversary_start_epoch=0)
    raw = tiny_batch(np.random.RandomState(0))
    batch, plan = _plan(jcfg, raw)
    jtr = JTrainer(model_cfg=jcfg, train_cfg=JTrainConfig(**TRAIN_KW, **FREEZE))
    state0 = jtr.init_state(jax.random.PRNGKey(0), batch)
    jgrads, japply = jax.jit(jtr._grads), jax.jit(jtr._apply)
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)
    state = state0
    for _ in range(3):
        state, _ = japply(state, *jgrads(state, batch, jnp.float32(1), jplan))
    yield dict(jcfg=jcfg, raw=TBatch(*raw), plan=plan, state=state,
               sd0=jax_to_state_dict(state0.params, state0.batch_stats),
               ref=jax_to_state_dict(state.params, state.batch_stats))


def test_freeze_detector_matches_jax(freeze):
    s = freeze
    tr = TTrainer(_port_cfg(s["jcfg"]), TTrainConfig(**TRAIN_KW, **FREEZE), device="cpu")
    tr.init_state(state_dict=s["sd0"])
    for _ in range(3):
        logs = tr.train_step(s["raw"], 1, s["plan"])
    assert float(logs["perturbation_l2_norm"]) > 0  # the adversary runs from epoch 0
    assert tr.state.count == 3 and int(tr.state.nan_count) == 0
    got = tr.model.state_dict()
    params = dict(tr.model.named_parameters())
    det = [k for k in params if not k.startswith("adversary.")]
    adv = [k for k in params if k.startswith("adversary.")]
    for k in det:
        assert torch.equal(got[k].view(torch.int32), s["sd0"][k].view(torch.int32)), k
        assert torch.equal(got[k].view(torch.int32), s["ref"][k].view(torch.int32)), k
    # the detector chain's Adam moments advance all the same, as in JAX
    assert tr.state.mu["bbox_head.conv_cls.weight"].abs().max() > 0
    assert any(not torch.equal(got[k], s["sd0"][k]) for k in adv)
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert any(not torch.equal(got[k], s["sd0"][k]) for k in stats)  # train-mode BN still moves
    cfg = TTrainConfig(**TRAIN_KW, **FREEZE)
    _held_to(got, s["ref"], cfg.learning_rate * cfg.adversary_lr_mult, 3, adv + stats)
