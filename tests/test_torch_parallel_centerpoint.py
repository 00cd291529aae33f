"""The port's data-parallel CenterPoint step (CenterPointTrainer.compile_sharded) in 2 gloo ranks on the CPU.

One step at global B=4 (2 rows a rank) on the --tiny smoke grid at
CenterPoint's widths, float32 (compute_dtype, PERT_BF16 pinned off, the JAX
encoder's remat off), against JAX's `CenterPointTrainer.compile_sharded`
over a 2-device CPU mesh (conftest's virtual devices), from the same
weights (tools/convert.centerpoint_to_state_dict) with the same per-device
native sub-plans and CenterHead targets (the port's CenterPointPlanBuilder,
as tests/test_torch_centerpoint_train.py feeds both sides).

The tolerances are tests/test_torch_centerpoint_train.py's for the
one-device step: every parameter within 2 lr (+ the float32 rounding of p
+ update on each side) of JAX's, 99% of the entries within 0.05 lr (lr =
the warm-up's first value; Adam moves each entry by about lr * sign(g)
at its first step, so a ReLU gate the two sides round apart, which moves
some gradients of this 8 x 8-cell grid by percents, moves no update by
more than 2 lr); the BatchNorm running statistics within 1e-4 of each
tensor's scale; the averaged logs at LOSS_RTOL 2e-5. Both ranks' states
equal each other and the one-process emulation bit for bit.
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
from robustpointclouds_tpu.parallel import make_mesh, replicate, shard_batch as jax_shard_batch
from robustpointclouds_tpu.parallel import shard_stacked, stack_plans
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig
from robustpointclouds_tpu.train.centerpoint_loop import CenterPointTrainer as JTrainer

from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch as TBatch
from robustpointclouds_tpu_torch.models import centerpoint as tcp
from robustpointclouds_tpu_torch.parallel.mesh import row_block
from robustpointclouds_tpu_torch.parallel.multihost import launch_local
from robustpointclouds_tpu_torch.tools.convert import centerpoint_to_state_dict
from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer as TTrainer
from robustpointclouds_tpu_torch.train.loop import TrainConfig as TTrainConfig

import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)
from torch_dp_ranks import emulate_step, make_trainer, step_cases

WORLD = 2
EPOCH = 5  # the adversary on
TRAIN_KW = dict(learning_rate=5e-5, grad_clip_norm=1.0, adversary_lr_mult=1.0, warmup_iters=5,
                max_epochs=2, steps_per_epoch=4)
LOSS_RTOL = 2e-5
BN_RTOL = 1e-4  # of each running statistic's largest entry


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import robustpointclouds_tpu.nn.perturber as jprt
    import robustpointclouds_tpu_torch.nn.perturber as tprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    mp.setenv("RPC_CP_REMAT", "0")

    jcfg, num_points = jax_tiny_cfg(jcp.CenterPointConfig())
    jcfg = jcfg._replace(compute_dtype="float32")
    tcfg, _ = tiny_centerpoint_cfg(tcp.CenterPointConfig(compute_dtype="float32"))
    raw, vel = synthetic_nuscenes_batch(np.random.RandomState(3), batch_size=4,
                                        num_points=num_points, max_gt=jcfg.head.max_objs,
                                        num_objects=6, point_range=jcfg.voxelizer.point_cloud_range)
    builder = TTrainer(tcfg, TTrainConfig(**TRAIN_KW), device="cpu").make_plan_builder()
    plans = []
    for r in range(WORLD):
        rows = row_block(4, r, WORLD)
        plans.append(builder(*(np.asarray(x)[rows] for x in raw), np.asarray(vel)[rows]))

    batch = PointCloudBatch(*(jnp.asarray(x) for x in raw))
    jtr = JTrainer(model_cfg=jcfg, train_cfg=JTrainConfig(**TRAIN_KW))
    state0 = jtr.init_state(jax.random.PRNGKey(0), batch)
    mesh = make_mesh(jax.devices()[:WORLD])
    with mesh:
        jtr.compile_sharded(mesh, donate=False)
        jstate, jlogs = jtr.train_step(
            replicate(state0, mesh), jax_shard_batch(batch, mesh),
            jax_shard_batch(jnp.asarray(vel), mesh), EPOCH,
            shard_stacked(stack_plans([jax.tree_util.tree_map(jnp.asarray, p) for p in plans]),
                          mesh))
    case = dict(family="centerpoint", cfg=tcfg, train_kw=TRAIN_KW, epoch=EPOCH,
                batch=TBatch(*raw), plans=plans,
                sd0=centerpoint_to_state_dict(state0.params, state0.batch_stats))
    ranks = launch_local(step_cases, WORLD, ({"centerpoint": case},), backend="gloo",
                         init_file=str(tmp_path_factory.mktemp("rdzv") / "rdzv"))
    yield dict(case=case, ranks=[r["centerpoint"] for r in ranks], jstate=jstate, jlogs=jlogs)
    mp.undo()


def test_centerpoint_step_matches_jax_compile_sharded(setup):
    s = setup
    got = s["ranks"][0]
    assert sorted(got["logs"]) == sorted(s["jlogs"])
    for k, v in s["jlogs"].items():  # the logs averaged over the ranks, as JAX's pmean
        np.testing.assert_allclose(got["logs"][k], float(v), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    assert got["logs"]["perturbation_l2_norm"] > 0
    ref = centerpoint_to_state_dict(s["jstate"].params, s["jstate"].batch_stats)
    lr = TTrainer(s["case"]["cfg"], TTrainConfig(**TRAIN_KW), device="cpu").det_tx.schedule(0)
    moved, diffs = 0, []
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, r = got["state"][k].numpy(), r.numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, r, rtol=0, atol=BN_RTOL * max(np.abs(r).max(), 1e-6),
                                       err_msg=k)
        else:
            d = np.abs(g - r)
            assert d.max() <= 2 * lr + 2 * np.spacing(np.abs(r).max()), (k, d.max())
            diffs.append(d.ravel())
            moved += int(not np.array_equal(g, s["case"]["sd0"][k].numpy()))
    assert np.quantile(np.concatenate(diffs), 0.99) <= 0.05 * lr
    assert moved > 100  # nearly every parameter tensor took the step
    assert (got["step"], got["nan_count"]) == (1, 0) and int(s["jstate"].step) == 1


def test_ranks_equal_each_other_and_the_one_process_emulation(setup):
    r0, r1 = setup["ranks"]
    assert r0["sha256"] == r1["sha256"]
    np.testing.assert_equal(r0["logs"], r1["logs"])
    c = setup["case"]
    emu = emulate_step(make_trainer(c), c["batch"], c["plans"], c["epoch"], WORLD)
    assert emu["sha256"] == r0["sha256"]
    for k, v in emu["state"].items():
        assert torch.equal(v, r0["state"][k]), k
    np.testing.assert_equal(emu["logs"], r0["logs"])
