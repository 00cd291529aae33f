"""CenterPoint NaN diagnosis (counterpart of robustpointclouds_tpu/tools/diag_centerpoint_nan.py).

    python -m robustpointclouds_tpu_torch.tools.diag_centerpoint_nan [--cpu]

Runs DIAG_STEPS train steps of the full-width CenterPoint
(`CenterPointConfig()`, B=4, `synthetic_nuscenes_batch(RandomState(0))`,
epoch 5, the inline step) on one fixed batch and prints, for each step, one
JSON line with the JAX tool's keys: `step`, `loss` (every log of the step),
`nonfinite_grad_leaves` (the first 12 names of parameters whose gradient
holds a non-finite entry), `n_nonfinite`, `is_nan_flag` and `top_grad_mag`
(the 3 largest gradient magnitudes, [name, max |g| rounded to 3 places]);
it ends with {"done": steps}. The gradients are read inside the step,
before its NaN sanitation (`Trainer.grad_probe`), so the first parameter
whose gradient blows up, and the step where it does, show. The names are
the port's `named_parameters`. `is_nan_flag` is the step's NaN flag: a
non-finite loss or gradient, the flag the NaN ladder counts (JAX's tool
prints the loss's flag alone; with a non-finite gradient and a finite loss
the two differ). JAX's tool takes a second forward for its probe; the
port reads the step's own gradients, the same numbers.

Env: DIAG_STEPS (20), DIAG_NOADV=1 (CenterPoint with adversary=None, to
tell the adversary's share of a blow-up), BENCH_CPU=1 (as --cpu). Runs on
the card unless --cpu; raises without one.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.nuscenes import synthetic_nuscenes_batch
from ..models.centerpoint import CenterPointConfig
from ..train.centerpoint_loop import CenterPointTrainer

TOP = 3  # gradient magnitudes a line lists
NAMES = 12  # non-finite leaves a line names
EPOCH = 5  # the adversary's epoch gate open


def diagnose(trainer: CenterPointTrainer, batch, gt_vel, steps: int,
             emit: Callable[[str], None] = print) -> List[Dict]:
    """`steps` inline train steps of `trainer` on one batch, each reported as
    one JSON line through `emit`; returns the records."""
    seen: Dict[str, torch.Tensor] = {}

    def probe(grads: Dict[str, torch.Tensor], is_nan: torch.Tensor) -> None:
        names = list(grads)
        seen["names"] = names
        seen["finite"] = torch.stack([torch.isfinite(g).all() for g in grads.values()])
        seen["gmax"] = torch.stack([g.detach().abs().max().float() for g in grads.values()])
        seen["is_nan"] = is_nan | ~seen["finite"].all()

    trainer.grad_probe = probe
    records = []
    try:
        for i in range(steps):
            logs = trainer.train_step(batch, EPOCH, None, gt_vel=gt_vel)
            names = seen["names"]
            finite = seen["finite"].cpu().tolist()
            gmax = seen["gmax"].cpu().tolist()
            bad = [k for k, ok in zip(names, finite) if not ok]
            top = sorted(((float(v), k) for k, v in zip(names, gmax)), reverse=True)[:TOP]
            rec = {
                "step": i,
                "loss": {k: float(v) for k, v in logs.items()},
                "nonfinite_grad_leaves": bad[:NAMES],
                "n_nonfinite": len(bad),
                "is_nan_flag": bool(seen["is_nan"]),
                "top_grad_mag": [[k, round(v, 3)] for v, k in top],
            }
            records.append(rec)
            emit(json.dumps(rec))
    finally:
        trainer.grad_probe = None
    emit(json.dumps({"done": steps}))
    return records


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    args = parse_args(argv)
    cpu = args.cpu or os.environ.get("BENCH_CPU", "0") == "1"
    steps = int(os.environ.get("DIAG_STEPS", "20"))
    cfg = CenterPointConfig()
    if os.environ.get("DIAG_NOADV", "0") == "1":
        cfg = cfg._replace(adversary=None)
    trainer = CenterPointTrainer(model_cfg=cfg, device="cpu" if cpu else None)
    trainer.init_state(0)
    dev = trainer.device
    print(f"backend: {dev.type}" + (f" ({torch.cuda.get_device_name(dev)})"
                                    if dev.type == "cuda" else ""), flush=True)
    batch, gt_vel = synthetic_nuscenes_batch(np.random.RandomState(0), batch_size=4)
    return diagnose(trainer, batch, gt_vel, steps, emit=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
