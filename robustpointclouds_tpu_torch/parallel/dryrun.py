"""One full adversarial train step over N gloo CPU ranks (counterpart of the JAX package's `__graft_entry__.dryrun_multichip`).

    python -m robustpointclouds_tpu_torch.parallel.dryrun [N]

JAX jits the step over an n-device mesh on virtual CPU devices, runs it on
tiny shapes and checks a finite loss, `step == 1` and that the work is
partitioned: the per-device FLOPs of the compiled module below 2/n of a
one-device step's. The port runs the same step data parallel: N ranks of
one gloo process group spawned on this machine
(parallel/multihost.launch_local), each with its row block of the global
batch (one row a rank, B = N as in JAX) and the host sub-plan of those rows
only (`Trainer.compile_sharded`: the rank's own plan, then one all-reduce
of gradients, BatchNorm statistics and logs). It checks:
  * a finite loss on every rank and `step == 1`;
  * every rank's weights, BatchNorm buffers and train state bit-equal after
    the step (cli/common.state_digest);
  * each rank's step saw B/N rows and only its own sub-plan's voxels: the
    sparse encoder's active rows equal the rank's sub-plan's voxel count,
    and the ranks' counts sum to the global plan's. This stands for JAX's
    FLOPs ratio (torch.utils.flop_counter does not see K1's operator).
Always on the CPU (it checks that the step partitions and runs, not speed).
"""
from __future__ import annotations

import os
import sys
import tempfile
from typing import Dict

import numpy as np

EPOCH = 5  # the adversary on, as JAX's dryrun
NUM_POINTS = 256


def tiny_cfg():
    """JAX dryrun's model: the 16 m smoke grid, 256 voxels of 3 points."""
    from ..models.voxelnet import VoxelNetConfig
    from ..ops.voxelize import VoxelizerConfig

    return VoxelNetConfig(
        voxelizer=VoxelizerConfig(point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
                                  voxel_size=(0.5, 0.5, 0.125), max_points_per_voxel=3,
                                  max_voxels=256),
        anchor_ranges=((0, -8.0, -0.6, 16.0, 8.0, -0.6),) * 3)


def global_batch(world: int):
    """JAX dryrun's batch: B = world rows of NUM_POINTS points, 2 objects each."""
    from ..data.synthetic import synthetic_kitti_batch

    return synthetic_kitti_batch(np.random.RandomState(0), batch_size=world,
                                 num_points=NUM_POINTS, max_gt=8, num_objects=2,
                                 point_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0))


def _rank(rank: int, world: int) -> Dict:
    """One rank: its rows, its sub-plan, one data-parallel step at EPOCH."""
    import torch
    import torch.distributed as dist

    from ..cli.common import state_digest
    from ..parallel.mesh import shard_batch
    from ..train.loop import TrainConfig, Trainer

    tr = Trainer(tiny_cfg(), TrainConfig(warmup_iters=5), device="cpu")
    tr.init_state(0)
    tr.compile_sharded(dist.group.WORLD)
    batch = global_batch(world)
    rows = shard_batch(batch, rank, world)
    builder = tr.make_plan_builder()
    plan = builder(rows.points, rows.points_mask, rows.gt_boxes, rows.gt_labels, rows.gt_mask)
    seen = []
    hook = tr.model.middle_encoder.register_forward_pre_hook(
        lambda mod, args: seen.append(int(args[1].mask.sum())))
    logs = tr.train_step(rows, EPOCH, plan)
    hook.remove()
    global_plan = builder(batch.points, batch.points_mask)
    return {"loss": float(logs["loss"]), "l2": float(logs["perturbation_l2_norm"]),
            "step": tr.state.step, "digest": state_digest(tr),
            "rows": int(plan["voxels"].shape[0]), "voxels_seen": seen,
            "own_voxels": int(np.asarray(plan["voxel_mask"]).sum()),
            "global_voxels": int(np.asarray(global_plan["voxel_mask"]).sum()),
            "threads": torch.get_num_threads()}


def dryrun_multichip(n_devices: int) -> Dict:
    """Run the step over `n_devices` gloo CPU ranks, check it (module
    docstring), print one line in JAX's format; returns rank 0's result
    with every rank's voxel counts."""
    from .multihost import launch_local

    with tempfile.TemporaryDirectory() as tmp:
        results = launch_local(_rank, n_devices, backend="gloo",
                               init_file=os.path.join(tmp, "rendezvous"))
    r0 = results[0]
    losses = [r["loss"] for r in results]
    if not np.isfinite(losses).all() or len(set(losses)) != 1:
        raise AssertionError(f"multichip step: losses {losses} (finite and averaged expected)")
    if any(r["step"] != 1 for r in results):
        raise AssertionError(f"multichip step: steps {[r['step'] for r in results]}")
    if len({r["digest"] for r in results}) != 1:
        raise AssertionError("multichip step: the ranks' weights / BN buffers / state differ")
    for rank, r in enumerate(results):
        if r["rows"] != 1 or r["voxels_seen"] != [r["own_voxels"]]:
            raise AssertionError(f"rank {rank} saw {r['rows']} rows and {r['voxels_seen']} "
                                 f"voxels, its sub-plan holds 1 row and {r['own_voxels']}")
    own = [r["own_voxels"] for r in results]
    if sum(own) != r0["global_voxels"]:
        raise AssertionError(f"the ranks' voxels {own} do not partition the global plan's "
                             f"{r0['global_voxels']}")
    ratio = max(own) / max(r0["global_voxels"], 1)
    if n_devices >= 4 and not ratio < 2.0 / n_devices:
        raise AssertionError(f"per-rank work not partitioned: {max(own)} of "
                             f"{r0['global_voxels']} voxels ({ratio:.3f}, want < "
                             f"{2.0 / n_devices})")
    print(f"dryrun_multichip OK: {n_devices} devices, loss={r0['loss']:.4f}, "
          f"l2={r0['l2']:.5f}, voxels/device={max(own)} ({ratio:.3f}x the global plan's)",
          flush=True)
    return dict(r0, own_voxels_by_rank=own)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
