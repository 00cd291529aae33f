"""The inline adversarial train step (`Trainer.train_step(batch, epoch,
None)`: the plan built on the device, the adversary on), driven back to back
over the traffic's pool.

Set-up builds one trainer from the run's weights and drives it through its
first three steps on three different batches, reading what the check
compares: each step's detection loss, the first step's head outputs (a
forward hook on the head module), the first gradient's norm leaf by leaf
as the optimizer got it (its first moment after one step over 1 - beta1),
each parameter's change over the three steps, and the first step's
adversary terms (its perturbation's L2 norm and, where the family logs
them, the intensity, bias and imbalance terms and the perturbation's mean
and spread). Two more steps warm up;
the same trainer then runs the window."""
from __future__ import annotations

import time
from typing import Dict

import torch

from ..reference.train import ADVERSARY_LOGS

FIRST_STEPS = 3
WARM_STEPS = 2


def _norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].float()) for k in names]) * scale
    return dict(zip(names, vals.tolist()))


class Entry:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx
        self.epoch = float(ctx.traffic["epoch"])
        prog = ctx.program
        self.batches = [prog.batch(b) for b in ctx.pool]
        self.frames_per_step = int(ctx.traffic["batch"])
        self.trainer = prog.trainer(ctx.cfg, ctx.device)
        self.trainer.init_state(state_dict=ctx.weights)
        params = dict(self.trainer.model.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        b1 = self.trainer.train_cfg.betas[0]
        self.readings = {"loss": []}
        hook = prog.train_head(self.trainer).register_forward_hook(self._on_head)
        for i in range(FIRST_STEPS):
            logs = prog.train_step(self.trainer, self.batches[i], self.epoch)
            hook.remove()
            self.readings["loss"].append(float(logs["loss"]))
            if i == 0:
                self.readings["grad"] = _norms(self.trainer.state.mu, 1.0 / (1.0 - b1))
                self.readings["adversary"] = {k: float(v) for k, v in logs.items()
                                              if k in ADVERSARY_LOGS}
        self.readings["change"] = _norms({k: p.detach() - start[k] for k, p in params.items()})
        del start
        self.first = FIRST_STEPS + WARM_STEPS
        for i in range(FIRST_STEPS, self.first):
            prog.train_step(self.trainer, self.batches[i], self.epoch)
        ctx.sync()

    def _on_head(self, module, args, output):
        self.readings["heads"] = {k: v.detach().float().cpu()
                                  for k, v in self.ctx.program.heads(output).items()}

    def pool_index(self, n: int) -> int:
        return (self.first + n) % len(self.batches)

    def step(self, n: int) -> None:
        self.ctx.program.train_step(self.trainer, self.batches[self.pool_index(n)], self.epoch)

    def window(self, seconds: float, sync) -> Dict:
        """Steps back to back until `seconds` have passed; the window closes
        when the last step's work has finished."""
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.step(n)
            n += 1
        sync()
        return {"steps": n, "seconds": time.perf_counter() - t0}

    def release(self) -> None:
        del self.trainer

    def check(self, ref) -> Dict[str, float]:
        """The reference's three steps from the same weights on the same
        batches, and the gaps (check.train_gaps)."""
        from .. import check
        from ..reference import train

        got = train.three_steps(ref, self.ctx.weights, self.ctx.pool[:FIRST_STEPS], self.epoch,
                                self.ctx.cfg["optim"])
        self.reference_readings = got
        return check.train_gaps(self.readings, got)
