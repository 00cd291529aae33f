"""Multi-process data-parallel training over torch.distributed (counterpart of robustpointclouds_tpu/parallel/multihost.py).

The reference launches DDP through mmengine's `--launcher pytorch`
(torchrun); JAX runs one process a host under `jax.distributed.initialize`.
The port runs one process a card, each a rank of one process group:

  * `init_multihost` joins the group: the JAX CLI's names first
    (`--coordinator` / `--num-processes` / `--process-id`, else
    `JAX_COORDINATOR_ADDRESS` / `JAX_NUM_PROCESSES` / `JAX_PROCESS_ID`),
    then torchrun's (`MASTER_ADDR` + `MASTER_PORT`, `WORLD_SIZE`, `RANK`;
    `LOCAL_RANK` picks the card, `local_device_index`). The backend is the
    caller's explicit choice: NCCL on cards, gloo on the CPU;
  * every process runs the same seeded loader over the whole global batch
    and keeps its rows (`host_rows`), as the reference's DistributedSampler
    with a shared seed;
  * `launch_local` starts N ranks on one machine (the CLIs' `--devices N`)
    with the spawn start method.

No counterpart: `globalize`, `globalize_stacked_plans` and
`replicate_multihost` (a process already holds its own rows and plan, and
parallel/mesh.replicate broadcasts the state from rank 0).
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from .mesh import row_block

# every collective's time limit: validation runs on rank 0 alone while the
# other ranks wait in the next step's all-reduce (NCCL's default is 10 min)
TIMEOUT = datetime.timedelta(hours=2)


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return None


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None, process_id: Optional[int] = None, *,
                   backend: str) -> Tuple[int, int]:
    """`torch.distributed.init_process_group` from the JAX CLI's names or
    torchrun's environment; returns (process_index, process_count).
    `coordinator_address`: host:port of rank 0's store (tcp), or an
    init_method URL (`file://...`). `backend`: "nccl" or "gloo"; a failed
    rendezvous raises, nothing carries on alone."""
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not addr and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if not addr:
        raise ValueError("--multihost needs a coordinator: --coordinator host:port, "
                         "JAX_COORDINATOR_ADDRESS, or torchrun's MASTER_ADDR and MASTER_PORT")
    nproc = num_processes if num_processes is not None else _env_int("JAX_NUM_PROCESSES",
                                                                     "WORLD_SIZE")
    pid = process_id if process_id is not None else _env_int("JAX_PROCESS_ID", "RANK")
    if nproc is None or pid is None:
        raise ValueError("--multihost needs the process count and this process's id: "
                         "--num-processes / --process-id, JAX_NUM_PROCESSES / "
                         "JAX_PROCESS_ID, or torchrun's WORLD_SIZE / RANK")
    init_method = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=init_method, world_size=nproc, rank=pid,
                            timeout=TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def local_device_index() -> int:
    """This process's card on its host: torchrun's LOCAL_RANK, else 0."""
    return _env_int("LOCAL_RANK") or 0


def host_rows(global_batch_size: int, rank: Optional[int] = None,
              world: Optional[int] = None) -> slice:
    """This process's contiguous row block of each global batch (its rank
    and the world size of the default group unless given)."""
    if rank is None or world is None:
        rank, world = dist.get_rank(), dist.get_world_size()
    return row_block(global_batch_size, rank, world)


def _rank_main(rank: int, fn: Callable, world: int, args: Sequence[Any], backend: str,
               init_file: str, use_cuda: bool, results) -> None:
    """One spawned rank: join the group, run fn(rank, world, *args), send
    its pickled result to the parent, leave the group. CPU ranks share
    the machine's cores."""
    if use_cuda:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=TIMEOUT)
    try:
        out = fn(rank, world, *args)
        results.put((rank, pickle.dumps(out)))
    finally:
        dist.destroy_process_group()


def launch_local(fn: Callable, world: int, args: Sequence[Any] = (), *, backend: str,
                 init_file: str, use_cuda: bool = False) -> List[Any]:
    """Run fn(rank, world, *args) in `world` spawned processes, ranks of one
    group over `backend` met through `init_file` (which must not exist yet);
    rank r takes cuda:r when `use_cuda`. Returns each rank's result in rank
    order. A rank that fails stops the others and raises here. `fn` and
    `args` must pickle: a module-level function and plain values."""
    if os.path.exists(init_file):
        raise FileExistsError(f"rendezvous file {init_file} exists: another group met there")
    results = tmp.get_context("spawn").Queue()
    ctx = tmp.start_processes(_rank_main, args=(fn, world, tuple(args), backend, init_file,
                                                use_cuda, results),
                              nprocs=world, join=False, start_method="spawn")
    got = {}
    try:
        exited = False
        while len(got) < world:  # drain the queue before joining its writers
            try:
                rank, blob = results.get(timeout=1.0)
            except queue.Empty:
                if exited:
                    break
                exited = ctx.join(timeout=0)  # raises if a rank failed
                continue
            got[rank] = pickle.loads(blob)
        while not ctx.join(timeout=1.0):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        if os.path.exists(init_file):
            os.remove(init_file)
    if len(got) < world:
        raise RuntimeError(f"launch_local: {world - len(got)} of {world} ranks returned no result")
    return [got[r] for r in range(world)]
