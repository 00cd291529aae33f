"""The reference's first three train steps: from the run's weights, on the
run's first three batches, float32 with TF32 off, the two Adam chains of
optim.py. Returns the readings the check compares: each step's detection
loss, the first step's head outputs, adversary terms and gradient, the
parameters' change over the three steps."""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .optim import TwoChains

# the adversary's terms of a step's logs that the check compares
ADVERSARY_LOGS = ("perturbation_l2_norm", "loss_intensity", "loss_bias", "loss_imbalance",
                  "mean_perturbation", "std_perturbation")


def three_steps(ref, weights: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]],
                epoch: float, optim_cfg: Dict, timings: Optional[List] = None) -> Dict:
    """`timings`, when given, receives (phase, seconds) of each step's
    forward, backward and update, the device synchronised around each."""
    def mark(name, t0):
        if timings is None:
            return t0
        if batches[0]["points"].is_cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        timings.append((name, t1 - t0))
        return t1

    model = ref.model
    model.load_state_dict(weights)
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    bn = [b for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
          for b in (m.running_mean, m.running_var)]
    chains = TwoChains(params, optim_cfg)
    b1 = optim_cfg["betas"][0]
    out: Dict = {"loss": []}
    for i, batch in enumerate(batches):
        model.train()
        for p in params.values():
            p.grad = None
        old = [b.clone() for b in bn]
        t = mark("start", time.perf_counter())
        total, det, logs, heads = ref.train_loss(batch, epoch)
        t = mark("forward", t)
        is_nan = not bool(torch.isfinite(total))
        if is_nan:
            total = total * 0.0
        total.backward()
        t = mark("backward", t)
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        is_nan = is_nan or not all(bool(torch.isfinite(g).all()) for g in grads.values())
        grads = {k: torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0) for k, g in grads.items()}
        if is_nan:
            with torch.no_grad():
                for b, o in zip(bn, old):
                    b.copy_(o)
        chains.step(params, grads, is_nan)
        out["loss"].append(float(det.detach()))
        mark("update", t)
        if i == 0:
            out["heads"] = {k: v.detach().float().cpu() for k, v in heads.items()}
            out["adversary"] = {k: float(v.detach()) for k, v in logs.items()
                                if k in ADVERSARY_LOGS}
            out["grad"] = {k: float(torch.linalg.vector_norm(m)) / (1.0 - b1)
                           for k, m in chains.mu.items()}
    out["change"] = {k: float(torch.linalg.vector_norm(p.detach() - start[k]))
                     for k, p in params.items()}
    return out
