"""The port's data-parallel step in spawned CPU ranks, and its one-process emulation.

`step_cases` is the body of each rank that tests/test_torch_parallel*.py
start with parallel/multihost.launch_local over gloo: for every case it
builds the trainer from the same weights, takes this rank's rows of the
global batch and this rank's plan, and runs one data-parallel train step.
`emulate_step` is the same step in one process: each sub-batch's `_grads`
from the same starting state, summed and halved as the all-reduce does,
the BatchNorm running statistics likewise, then `_apply`. Both pin torch
to one thread: oneDNN / MKL reductions may change with the thread count,
and the comparison is bit for bit. Imports torch, numpy and the port only.
"""
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from robustpointclouds_tpu_torch.cli.common import state_digest
from robustpointclouds_tpu_torch.models.voxelnet import plan_to_device
from robustpointclouds_tpu_torch.parallel.mesh import shard_batch
from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer
from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer


def make_trainer(case) -> Trainer:
    cls = CenterPointTrainer if case["family"] == "centerpoint" else Trainer
    tr = cls(case["cfg"], TrainConfig(**case["train_kw"]), device="cpu")
    tr.init_state(state_dict=case["sd0"])
    return tr


def _float32_perturber():
    import robustpointclouds_tpu_torch.nn.perturber as prt

    prt.PERT_BF16 = False  # the parity tests' float32 pin (tests/test_torch_train.py)


def _result(tr: Trainer, logs, with_state: bool) -> Dict:
    st = tr.state
    out = {"sha256": state_digest(tr), "logs": {k: float(v) for k, v in logs.items()},
           "step": st.step, "count": st.count, "nan_count": int(st.nan_count),
           "consecutive_nan": int(st.consecutive_nan)}
    if with_state:
        out["state"] = {k: v.clone() for k, v in tr.model.state_dict().items()}
    return out


def step_cases(rank: int, world: int, cases: Dict[str, Dict]) -> Dict[str, Dict]:
    """One data-parallel step per case on this rank; rank 0 also returns
    the model's state_dict. A case's `nan_rank` gets its plan's voxels set
    to NaN on that rank."""
    torch.set_num_threads(1)
    _float32_perturber()
    out = {}
    for name, case in cases.items():
        tr = make_trainer(case).compile_sharded(dist.group.WORLD)
        plan = dict(case["plans"][rank])
        if case.get("nan_rank") == rank:
            plan["voxels"] = np.full_like(plan["voxels"], np.nan)
        logs = tr.train_step(shard_batch(case["batch"], rank, world), case["epoch"], plan)
        out[name] = _result(tr, logs, with_state=rank == 0)
    return out


def emulate_step(tr: Trainer, batch, plans, epoch: float, world: int, nan_rank=None) -> Dict:
    """One data-parallel step of `world` ranks in this process, on the
    initialised trainer `tr` (any device): rank r's rows of `batch` with
    `plans[r]` (numpy; its voxels NaN on `nan_rank`). Returns the step's
    result as `step_cases` does, with the state."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        buffers = {k: b.clone() for k, b in tr.model.named_buffers()}
        old_stats = [b.clone() for b in tr._bn_buffers()]
        grads: List[Dict[str, torch.Tensor]] = []
        stats, logs, nans = [], [], []
        for r in range(world):
            with torch.no_grad():  # every sub-batch starts from the same buffers
                for k, b in tr.model.named_buffers():
                    b.copy_(buffers[k])
            plan = dict(plans[r])
            if nan_rank == r:
                plan["voxels"] = np.full_like(plan["voxels"], np.nan)
            if isinstance(tr, CenterPointTrainer):
                g, lg, n = tr._grads(None, float(epoch), plan_to_device(plan, tr.device))
            else:
                gt, plan_t = tr._to_device(shard_batch(batch, r, world), plan)
                g, lg, n = tr._grads(gt, float(epoch), plan_t)
            grads.append({k: v.clone() for k, v in g.items()})
            stats.append([b.clone() for b in tr._bn_buffers()])
            logs.append(lg)
            nans.append(n)

        def mean(xs):
            total = xs[0].to(torch.float32)
            for x in xs[1:]:
                total = total + x.to(torch.float32)
            return (total / world).to(xs[0].dtype)

        g_avg = {k: mean([g[k] for g in grads]) for k in grads[0]}
        with torch.no_grad():
            for i, b in enumerate(tr._bn_buffers()):
                b.copy_(mean([s[i] for s in stats]))
        l_avg = {k: mean([lg[k] for lg in logs]) for k in logs[0]}
        tr._apply(g_avg, torch.stack(nans).any(), old_stats)
        return _result(tr, l_avg, with_state=True)
    finally:
        torch.set_num_threads(threads)
