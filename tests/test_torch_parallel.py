"""The port's data-parallel step (train/loop.Trainer.compile_sharded) in 2 gloo ranks on the CPU.

Against JAX: one SECOND step at global B=4 (2 rows a rank) on the 16 m
smoke grid at SECOND's widths, float32 (PERT_BF16 pinned off on both
sides), against JAX's `Trainer.compile_sharded` over a 2-device CPU mesh
(conftest's virtual devices), from the same weights
(tools/convert.jax_to_state_dict) with the same per-device native sub-plans
and anchor assignments. The tolerances are tests/test_torch_train.py's for
the one-device step: every parameter within 2 lr of JAX's and 99% of the
entries within 0.05 lr (Adam moves each by about lr * sign(g), whatever
|g|, so where g is float32 noise on both sides the updates differ by up to
2 lr); the BatchNorm running statistics at rtol 1e-4 / atol 1e-5; the
averaged logs at LOSS_RTOL 5e-5.

Across ranks: both ranks' states (model, Adam moments, counters) are equal
bit for bit to each other and to the one-process emulation
(tests/torch_dp_ranks.emulate_step), for SECOND and PointPillars. A NaN in
one rank's voxels is a NaN step on both: parameters and BatchNorm buffers
unchanged, one NaN counted. JAX's refusals of a batch the ranks do not
divide. One JAX compile, one launch of the two ranks for every case.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.cli.common import tiny_voxelnet_cfg
from robustpointclouds_tpu.data.native_plan import build_plan_native
from robustpointclouds_tpu.data.structures import PointCloudBatch
from robustpointclouds_tpu.models import voxelnet as jvn
from robustpointclouds_tpu.parallel import make_mesh, replicate, shard_batch as jax_shard_batch
from robustpointclouds_tpu.parallel import shard_stacked, stack_plans
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig, Trainer as JTrainer

from robustpointclouds_tpu_torch.cli.common import tiny_pointpillars_cfg
from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch as TBatch
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig as TVoxelizerConfig
from robustpointclouds_tpu_torch.parallel.mesh import row_block, shard_batch
from robustpointclouds_tpu_torch.parallel.multihost import host_rows, launch_local
from robustpointclouds_tpu_torch.tools.convert import jax_to_state_dict
from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

from test_model import tiny_batch
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)
from torch_dp_ranks import emulate_step, make_trainer, step_cases

WORLD = 2
EPOCH = 5  # the adversary on
TRAIN_KW = dict(warmup_iters=5, max_epochs=2, steps_per_epoch=4)
LOSS_RTOL = 5e-5
BN_RTOL, BN_ATOL = 1e-4, 1e-5


def _sub_plans_jax(jcfg, raw):
    """Each rank's native plan and JAX anchor assignment, numpy."""
    plans = []
    for r in range(WORLD):
        rows = row_block(raw.points.shape[0], r, WORLD)
        sub = PointCloudBatch(*(jnp.asarray(np.asarray(x)[rows]) for x in raw))
        plan = build_plan_native(np.asarray(sub.points), np.asarray(sub.points_mask),
                                 jcfg.voxelizer, 4)
        plan["assign"] = jax.tree_util.tree_map(np.asarray, jvn.anchor_assign_plan(
            sub.gt_boxes, sub.gt_labels, sub.gt_mask, jcfg))
        plans.append(plan)
    return plans


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import robustpointclouds_tpu.nn.perturber as jprt
    import robustpointclouds_tpu_torch.nn.perturber as tprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)

    # SECOND: JAX's sharded step and the port's, from the same weights and plans
    jcfg = tiny_voxelnet_cfg()._replace(compute_dtype="float32")
    raw = tiny_batch(np.random.RandomState(0), B=4)
    batch = PointCloudBatch(*(jnp.asarray(x) for x in raw))
    plans = _sub_plans_jax(jcfg, raw)
    jtr = JTrainer(model_cfg=jcfg, train_cfg=JTrainConfig(**TRAIN_KW))
    state0 = jtr.init_state(jax.random.PRNGKey(0), batch)
    mesh = make_mesh(jax.devices()[:WORLD])
    with mesh:
        jtr.compile_sharded(mesh, donate=False)
        jstate, jlogs = jtr.train_step(
            replicate(state0, mesh), jax_shard_batch(batch, mesh), EPOCH,
            shard_stacked(stack_plans([jax.tree_util.tree_map(jnp.asarray, p) for p in plans]),
                          mesh))
    vz = jcfg.voxelizer
    tcfg = tvn.VoxelNetConfig(
        voxelizer=TVoxelizerConfig(vz.point_cloud_range, vz.voxel_size, vz.max_points_per_voxel,
                                   vz.max_voxels),
        anchor_ranges=jcfg.anchor_ranges, compute_dtype="float32")
    second = dict(family="anchor", cfg=tcfg, train_kw=TRAIN_KW, epoch=EPOCH, batch=TBatch(*raw),
                  plans=plans, sd0=jax_to_state_dict(state0.params, state0.batch_stats))

    # PointPillars: the port's pillar plans, weights from a seed
    pcfg = tiny_pointpillars_cfg()._replace(compute_dtype="float32")
    praw = TBatch(*tiny_batch(np.random.RandomState(1), B=4))
    ptr = Trainer(pcfg, TrainConfig(**TRAIN_KW), device="cpu")
    ptr.init_state(0)
    builder = ptr.make_plan_builder()
    pplans = [builder(*(np.asarray(x)[row_block(4, r, WORLD)] for x in praw))
              for r in range(WORLD)]
    pillars = dict(family="anchor", cfg=pcfg, train_kw=TRAIN_KW, epoch=EPOCH, batch=praw,
                   plans=pplans, sd0={k: v.clone() for k, v in ptr.model.state_dict().items()})

    cases = {"second": second, "pointpillars": pillars, "nan": dict(second, nan_rank=1)}
    ranks = launch_local(step_cases, WORLD, (cases,), backend="gloo",
                         init_file=str(tmp_path_factory.mktemp("rdzv") / "rdzv"))
    yield dict(cases=cases, ranks=ranks, jstate=jstate, jlogs=jlogs, state0=state0)
    mp.undo()


def test_second_step_matches_jax_compile_sharded(setup):
    s = setup
    got = s["ranks"][0]["second"]
    assert not any(np.isnan(v) for v in got["logs"].values())
    assert sorted(got["logs"]) == sorted(s["jlogs"])
    for k, v in s["jlogs"].items():  # the logs averaged over the ranks, as JAX's pmean
        np.testing.assert_allclose(got["logs"][k], float(v), rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
    ref = jax_to_state_dict(s["jstate"].params, s["jstate"].batch_stats)
    lr = TrainConfig(**TRAIN_KW).learning_rate
    diffs = []
    for k, v in got["state"].items():
        if k.endswith("num_batches_tracked"):
            continue
        r = ref[k].numpy()
        if k.endswith(("running_mean", "running_var")):  # averaged over the ranks
            np.testing.assert_allclose(v.numpy(), r, rtol=BN_RTOL, atol=BN_ATOL, err_msg=k)
        else:
            d = np.abs(v.numpy() - r)
            assert d.max() <= 2 * lr, (k, d.max())
            diffs.append(d.ravel())
    assert np.quantile(np.concatenate(diffs), 0.99) <= 0.05 * lr
    sd0 = s["cases"]["second"]["sd0"]
    for k in ("middle_encoder.conv_input.0.weight", "adversary.mlp_0.weight",
              "middle_encoder.conv_input.1.running_mean"):
        assert not torch.equal(got["state"][k], sd0[k]), k  # the step moved them
    assert (got["step"], got["count"], got["nan_count"]) == (1, 1, 0)
    assert int(s["jstate"].nan_count) == 0


@pytest.mark.parametrize("case", ["second", "pointpillars", "nan"])
def test_ranks_equal_each_other_and_the_one_process_emulation(setup, case):
    r0, r1 = (r[case] for r in setup["ranks"])
    assert r0["sha256"] == r1["sha256"]  # model, Adam moments and counters, bit for bit
    np.testing.assert_equal(r0["logs"], r1["logs"])
    c = setup["cases"][case]
    emu = emulate_step(make_trainer(c), c["batch"], c["plans"], c["epoch"], WORLD,
                       c.get("nan_rank"))
    assert emu["sha256"] == r0["sha256"]
    for k, v in emu["state"].items():
        assert torch.equal(v, r0["state"][k]), k
    np.testing.assert_equal(emu["logs"], r0["logs"])


def test_a_nan_on_one_rank_is_a_nan_step_on_both(setup):
    sd0 = setup["cases"]["nan"]["sd0"]
    for ranks in setup["ranks"]:
        got = ranks["nan"]
        assert (got["step"], got["count"], got["nan_count"], got["consecutive_nan"]) == (1, 1, 1, 1)
        assert not np.isfinite(got["logs"]["loss"])  # rank 1's NaN loss in the average
    state = setup["ranks"][0]["nan"]["state"]
    for k, v in sd0.items():  # parameters and every BatchNorm buffer as before the step
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(state[k], v), k


def test_rows_and_refusals():
    b = TBatch(*tiny_batch(np.random.RandomState(2), B=4))
    halves = [shard_batch(b, r, 2) for r in range(2)]
    for field, x in zip(b._fields, b):
        np.testing.assert_array_equal(np.concatenate([getattr(h, field) for h in halves]), x)
    vel = np.arange(8.0).reshape(4, 2)
    sb, sv = shard_batch((b, vel), 1, 2)
    np.testing.assert_array_equal(sv, vel[2:])
    assert host_rows(6, 1, 3) == slice(2, 4)
    with pytest.raises(ValueError, match="global batch 6 not divisible by 4 processes"):
        host_rows(6, 0, 4)
    with pytest.raises(ValueError, match="global batch 3 not divisible by 2 processes"):
        shard_batch(TBatch(*tiny_batch(np.random.RandomState(2), B=3)), 0, 2)


def test_launch_local_raises_when_a_rank_fails(tmp_path):
    with pytest.raises(Exception, match="rank 1 refuses"):
        launch_local(_fail_on_rank_1, 2, backend="gloo", init_file=str(tmp_path / "rdzv"))
    assert not os.path.exists(tmp_path / "rdzv")


def _fail_on_rank_1(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 refuses")
    return rank
