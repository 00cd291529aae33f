"""The port against the JAX package in bfloat16, the type every user runs.

Both sides run with compute_dtype "bfloat16" and the adversary MLP in bf16
(PERT_BF16 pinned on for both, whatever the environment says), with the same
weights (carried over by tools/convert.jax_to_state_dict) and the same native
plan, on the tiny grid at the real SECOND widths. On the CPU the port takes
its kernels' plain versions (the bf16 sparse conv, K2's plain BatchNorm).

The tolerances come from the spread measured on this setup:

* Serving (eval mode, running statistics): bf16 rounding does not grow
  through the depth; the head outputs agree to one bf16 ulp of their largest
  entry (2^-9 at a scale of 0.42). They are held to 2^-6 of that scale. The
  adversary's aux terms (means and maxima of the bf16 delta) agree to 0.7%,
  held to 2%.
* The adversary alone in train mode, with gradients: no detector depth
  between the rounding and the loss, so the bf16 gradients agree to 1.3e-2 of
  each tensor's float32 norm, held to 5e-2. The Linear biases in front of a
  train-mode BatchNorm have a true gradient of 0; both sides hold bf16 noise
  there, held to twice the noise JAX's own bf16 run shows against its f32 run.
* One train step (train mode, batch statistics): bf16 rounding grows through
  the depth, from 3e-3 relative at the first BatchNorm to 2e-1 at the neck,
  so the losses move by 4% and the gradients by 83% (relative L2) between
  JAX's own bf16 and f32 steps. Two bf16 runs that round in different places
  then differ by as much as either differs from f32 (independent rounding of
  equal size gives sqrt(2) of it). So the port's bf16 step is held to the
  yardstick the reference gives itself: each loss term and the gradients of
  the whole model and of each module group within 2x of JAX's own bf16-vs-f32
  gap. Measured: at most 0.93x on the losses, 0.87x on the groups' gradients.
  A gap that wide would pass a zeroed gradient (its gap is the gradient's own
  norm, under 2x a gap of 83%), so each group's gradient is also held in
  direction and size to JAX's bf16 one: its cosine with it at least half the
  cosine of JAX's bf16 gradient with its f32 one (measured 0.53-0.96 against
  0.50-0.91: the two bf16 runs round the same weights alike, so they agree
  with each other better than with f32), and its norm within 2x of it
  (measured 1.01-1.30x). A zeroed, sign-flipped or unrelated gradient fails
  both. Single tensors are not held so: the attention layers' gradients,
  whose cotangent crosses the whole detector, reach 7x of JAX's own gap on
  their small norm while the adversary-alone test above holds them to
  1.3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustpointclouds_tpu.nn.perturber as jprt
import robustpointclouds_tpu_torch.nn.perturber as tprt
from robustpointclouds_tpu.cli.common import tiny_voxelnet_cfg
from robustpointclouds_tpu.data import synthetic_kitti_batch
from robustpointclouds_tpu.data.native_plan import build_plan_native
from robustpointclouds_tpu.data.structures import PointCloudBatch
from robustpointclouds_tpu.models import voxelnet as jvn
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig, Trainer as JTrainer

from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch as TBatch
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig as TVoxelizerConfig
from robustpointclouds_tpu_torch.tools.convert import jax_to_state_dict, perturber_to_state_dict
from robustpointclouds_tpu_torch.train.loop import TrainConfig as TTrainConfig, Trainer as TTrainer

from test_model import tiny_batch
from test_torch_serving import _randomise_bn
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

OUT_TOL = 2.0 ** -6        # of the largest head output
AUX_RTOL = 2e-2
ADV_GRAD_RTOL = 5e-2       # of the tensor's float32 gradient norm
NOISE_FACTOR = 2.0         # times the reference's own bf16-vs-f32 gap
TRAIN_KW = dict(warmup_iters=5, max_epochs=2, steps_per_epoch=4)
GROUPS = ("adversary.", "middle_encoder.", "backbone.", "neck.", "bbox_head.")


@pytest.fixture(scope="module")
def bf16():
    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", True)
    mp.setattr(tprt, "PERT_BF16", True)
    yield mp
    mp.undo()


def _port_cfg(jcfg):
    vz = jcfg.voxelizer
    return tvn.VoxelNetConfig(
        voxelizer=TVoxelizerConfig(vz.point_cloud_range, vz.voxel_size,
                                   vz.max_points_per_voxel, vz.max_voxels),
        anchor_ranges=jcfg.anchor_ranges, compute_dtype=jcfg.compute_dtype)


@pytest.fixture(scope="module")
def serving(bf16):
    jcfg = tiny_voxelnet_cfg()._replace(compute_dtype="bfloat16")
    rng = np.random.RandomState(0)
    batch = synthetic_kitti_batch(rng, batch_size=2, num_points=600, max_gt=4,
                                  num_objects=3, point_range=jcfg.voxelizer.point_cloud_range)
    plan = build_plan_native(np.asarray(batch.points), np.asarray(batch.points_mask),
                             jcfg.voxelizer, 4)
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)
    model = jvn.AdversarialVoxelNet(jcfg)
    pts, msk = jnp.asarray(batch.points), jnp.asarray(batch.points_mask)
    variables = model.init(jax.random.PRNGKey(0), pts, msk, True, 0, False, -1.0, jplan)
    params = _randomise_bn(dict(variables["params"]), rng)
    stats = _randomise_bn(dict(variables["batch_stats"]), rng)
    tmodel = tvn.AdversarialVoxelNet(_port_cfg(jcfg))
    tmodel.load_state_dict(jax_to_state_dict(params, stats))
    tmodel.eval()
    return dict(plan=plan, jplan=jplan, model=model, variables={"params": params,
                "batch_stats": stats}, pts=pts, msk=msk, tmodel=tmodel)


@pytest.mark.parametrize("attack", [False, True])
def test_serving_forward_matches_jax_in_bf16(serving, attack):
    s = serving
    ref = s["model"].apply(s["variables"], s["pts"], s["msk"], False, 100, attack, -1.0,
                           s["jplan"])
    with torch.no_grad():
        got = s["tmodel"](None, None, False, 100, attack, -1.0,
                          tvn.plan_to_device(s["plan"], torch.device("cpu")))
    for name in ("cls_scores", "bbox_preds", "dir_preds"):
        r = np.asarray(getattr(ref, name), np.float32)
        g = getattr(got, name).float().numpy()
        assert r.shape == g.shape, name
        np.testing.assert_allclose(g, r, rtol=0, atol=OUT_TOL * np.abs(r).max(), err_msg=name)
    assert sorted(ref.adv_aux) == sorted(got.adv_aux)
    for k in ref.adv_aux:
        np.testing.assert_allclose(float(got.adv_aux[k]), float(ref.adv_aux[k]),
                                   rtol=AUX_RTOL, atol=1e-6, err_msg=k)
    if attack:
        assert float(ref.adv_aux["max_perturbation"]) > 0.0  # the bf16 adversary ran


def _norm(a):
    return float(np.linalg.norm(np.asarray(a, np.float64).ravel()))


def _cos(a, b):
    na, nb = _norm(a), _norm(b)
    return float(np.dot(a, b) / (na * nb)) if na and nb else 0.0


def test_adversary_train_mode_gradients_match_jax_in_bf16(bf16):
    rng = np.random.RandomState(0)
    n = 1500
    feats = (rng.randn(n, 4) * [5.0, 5.0, 1.0, 0.3] + [8.0, 0.0, -1.0, 0.5]).astype(np.float32)
    mask = rng.rand(n) < 0.8
    w = rng.randn(n, 4).astype(np.float32)
    grads = {}
    for b16 in (True, False):
        bf16.setattr(jprt, "PERT_BF16", b16)
        bf16.setattr(tprt, "PERT_BF16", b16)
        jm = jprt.VoxelPerturber()
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(mask), True)

        def jloss(p):
            (out, aux), _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                                     jnp.asarray(feats), jnp.asarray(mask), True,
                                     mutable=["batch_stats"])
            return jnp.sum((out - feats) * w) + aux["l2_norm"]

        jg = jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(v["params"]))
        grads["jax", b16] = {k: t.numpy() for k, t in
                             perturber_to_state_dict(jg, v["batch_stats"]).items()}
        if b16:
            tm = tprt.VoxelPerturber()
            tm.load_state_dict(perturber_to_state_dict(v["params"], v["batch_stats"]))
            tm.train()
            out, aux = tm(torch.from_numpy(feats), torch.from_numpy(mask))
            (((out - torch.from_numpy(feats)) * torch.from_numpy(w)).sum()
             + aux["l2_norm"]).backward()
            grads["port"] = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    bf16.setattr(jprt, "PERT_BF16", True)
    bf16.setattr(tprt, "PERT_BF16", True)
    assert set(grads["port"]) <= set(grads["jax", True])
    for k, g in grads["port"].items():
        j16, j32 = grads["jax", True][k], grads["jax", False][k]
        tol = max(ADV_GRAD_RTOL * _norm(j32), NOISE_FACTOR * _norm(j16 - j32))
        assert _norm(g - j16) <= tol, (k, _norm(g - j16), tol)


def _train_grads(raw, dtype, epoch=5.0):
    """One step's (JAX grads, JAX logs, port grads, port logs) in `dtype`;
    port grads only for bfloat16."""
    jcfg = tiny_voxelnet_cfg()._replace(compute_dtype=dtype)
    batch = PointCloudBatch(*(jnp.asarray(x) for x in raw))
    plan = build_plan_native(np.asarray(raw.points), np.asarray(raw.points_mask),
                             jcfg.voxelizer, 4)
    plan["assign"] = jax.tree_util.tree_map(np.asarray, jvn.anchor_assign_plan(
        batch.gt_boxes, batch.gt_labels, batch.gt_mask, jcfg))
    jtr = JTrainer(model_cfg=jcfg, train_cfg=JTrainConfig(**TRAIN_KW))
    state0 = jtr.init_state(jax.random.PRNGKey(0), batch)
    grads, _, jlogs, jnan = jax.jit(jtr._grads)(state0, batch, jnp.float32(epoch),
                                               jax.tree_util.tree_map(jnp.asarray, plan))
    assert not bool(jnan)
    jg = {k: v.numpy() for k, v in jax_to_state_dict(grads, state0.batch_stats).items()}
    jlogs = {k: float(v) for k, v in jlogs.items()}
    if dtype != "bfloat16":
        return jg, jlogs, None, None
    ttr = TTrainer(_port_cfg(jcfg), TTrainConfig(**TRAIN_KW), device="cpu")
    ttr.init_state(state_dict=jax_to_state_dict(state0.params, state0.batch_stats))
    gt, plan_t = ttr._to_device(TBatch(*raw), plan)
    tg, tlogs, tnan = ttr._grads(gt, epoch, plan_t)
    assert not bool(tnan)
    return jg, jlogs, {k: v.float().numpy() for k, v in tg.items()}, \
        {k: float(v) for k, v in tlogs.items()}


def test_train_step_losses_and_gradients_match_jax_in_bf16(bf16):
    raw = tiny_batch(np.random.RandomState(0))
    j16, jlogs16, p16, plogs16 = _train_grads(raw, "bfloat16")
    bf16.setattr(jprt, "PERT_BF16", False)
    j32, jlogs32, _, _ = _train_grads(raw, "float32")
    bf16.setattr(jprt, "PERT_BF16", True)

    assert sorted(plogs16) == sorted(jlogs16)
    assert jlogs16["num_pos"] == plogs16["num_pos"] > 0
    for k, ref in jlogs16.items():
        gap = abs(plogs16[k] - ref)
        assert gap <= NOISE_FACTOR * abs(ref - jlogs32[k]) + 1e-6 * abs(ref), (k, gap)

    assert sorted(p16) == sorted(k for k in j16 if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked")))
    for k, g in p16.items():
        assert g.shape == j16[k].shape and np.isfinite(g).all(), k

    def flat(grads, prefix):
        return np.concatenate([np.asarray(grads[k], np.float64).ravel()
                               for k in sorted(p16) if k.startswith(prefix)])

    for prefix in ("",) + GROUPS:
        p, j, r = flat(p16, prefix), flat(j16, prefix), flat(j32, prefix)
        what = prefix or "whole model"
        gap, own = _norm(p - j), _norm(j - r)
        assert gap <= NOISE_FACTOR * own, (what, gap, own)
        # the direction and size of JAX's bf16 gradient, which the gap alone
        # does not hold: a zeroed gradient is within 2x a gap of 83%
        assert _cos(p, j) >= _cos(j, r) / NOISE_FACTOR, (what, _cos(p, j), _cos(j, r))
        assert 1 / NOISE_FACTOR <= _norm(p) / _norm(j) <= NOISE_FACTOR, (what, _norm(p), _norm(j))
    adv = flat(p16, "adversary.")
    assert _norm(adv) > 0.0  # epoch 5: the adversary learns
