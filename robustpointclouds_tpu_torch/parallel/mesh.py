"""Data parallelism over a torch.distributed process group (counterpart of robustpointclouds_tpu/parallel/mesh.py).

JAX shards the batch over a mesh's 'data' axis and runs the step under
shard_map, each device on its own rows with its own host sub-plan, then
pmeans gradients, BatchNorm running statistics and logs. The port runs one
process a device, each a rank of a process group: every rank runs the whole
step on its rows with its own host plan, then the trainer averages what
JAX's pmean averages in ONE all-reduce over one flat buffer a step
(`average_step`): sum over ranks, then divide by the world size, so every
rank holds the same bits.

No counterpart: `make_mesh` (the process group is the mesh), `stack_plans`
and `shard_stacked` (a rank holds only its own plan, so there is nothing to
stack or shard: the merged-batch index arrays that keep JAX from sharding
one global plan never leave their rank).
"""
from __future__ import annotations

import collections
from typing import Iterable, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn


def rank_and_world(group=None) -> Tuple[int, int]:
    """(this process's rank in `group`, the group's size); (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def row_block(global_batch_size: int, rank: int, world: int) -> slice:
    """Rows [rank * k, (rank + 1) * k) of a global batch of world * k rows."""
    if global_batch_size % world:
        raise ValueError(f"global batch {global_batch_size} not divisible by {world} processes")
    per = global_batch_size // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch, rank: int, world: int):
    """This rank's rows of every array of `batch`: a PointCloudBatch (any
    NamedTuple of batch-major arrays), or a tuple / list of such items, as
    the NuScenes loader's (batch, velocities)."""
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        rows = row_block(len(batch[0]), rank, world)
        return type(batch)(*(x[rows] for x in batch))
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(x, rank, world) for x in batch)
    return batch[row_block(len(batch), rank, world)]


def _src(group) -> int:
    """The global rank of the group's rank 0."""
    return dist.get_global_rank(group, 0) if group is not None else 0


def _tensors(obj: Union[nn.Module, Iterable[torch.Tensor]]) -> List[torch.Tensor]:
    if isinstance(obj, nn.Module):
        return [t.data for t in obj.state_dict(keep_vars=True).values()]
    return list(obj)


def replicate(obj: Union[nn.Module, Iterable[torch.Tensor]], group=None) -> None:
    """Rank 0's values on every rank of `group`, in place: a module's
    parameters and buffers, or a sequence of tensors. One broadcast per
    dtype and device, over the tensors flattened into one buffer."""
    buckets = collections.defaultdict(list)
    for t in _tensors(obj):
        buckets[(t.dtype, t.device)].append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, _src(group), group=group)
        offset = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def broadcast_ints(values: Sequence[int], group=None) -> List[int]:
    """Rank 0's integers on every rank."""
    box = [list(values)]
    dist.broadcast_object_list(box, _src(group), group=group)
    return [int(v) for v in box[0]]


def average_step(tensors: Sequence[torch.Tensor], is_nan: torch.Tensor, group
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The step's one collective: `tensors` (gradients, BatchNorm running
    statistics, logs) and this rank's NaN flag as 1.0 / 0.0, cast to
    float32 and concatenated into one flat buffer, summed over the group
    and divided by its size -> (the averaged tensors, new, in their own
    dtypes and shapes; the global NaN flag, True where any rank's flag was
    set). The flag's average is positive exactly when its sum is: JAX's
    `psum(is_nan) > 0`."""
    world = dist.get_world_size(group)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors]
                     + [is_nan.reshape(1).to(torch.float32)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(world)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape).to(t.dtype))
        offset += t.numel()
    return out, flat[-1] > 0


def barrier(group, device: torch.device) -> None:
    """Every rank of `group` waits here; NCCL's barrier is told its card."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group, device_ids=[device.index or 0])
    else:
        dist.barrier(group)
