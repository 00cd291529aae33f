"""Evaluate the newest NuScenes adversarial checkpoint (counterpart of robustpointclouds_tpu/cli/evaluate_adversarial_checkpoint.py).

    python -m robustpointclouds_tpu_torch.cli.evaluate_adversarial_checkpoint \
        [--work-dir DIR] [--data-root data/nuscenes] [--batch-size 1] \
        [--synthetic] [--frames 8] [--limit N] [--tiny] [--cpu]

Picks the highest-epoch port checkpoint of --work-dir (the reference's
auto-pick) and scores it clean through evaluate_nuscenes_adversarial's
`evaluate`. Runs on the card unless --cpu; without a card and without
--cpu it raises.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Evaluate the newest NuScenes adversarial checkpoint")
    p.add_argument("--work-dir", default="work_dirs/nuscenes_adversarial_training")
    p.add_argument("--data-root", default="data/nuscenes")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--limit", type=int, default=None,
                   help="cap on real val frames (default: full split)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None,
         timings: Optional[Dict] = None) -> Optional[Dict[str, float]]:
    """Run the CLI; None when the work dir holds no checkpoint."""
    from ..core.device import resolve_device
    from ..train.checkpoint import CheckpointManager
    from .evaluate_nuscenes_adversarial import evaluate

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    latest = CheckpointManager(args.work_dir).latest_epoch()
    if latest is None:
        print(f"[error] no checkpoints under {args.work_dir}", flush=True)
        return None
    print(f"[eval] latest checkpoint: epoch {latest}", flush=True)
    res = evaluate(args.work_dir, args, attack=False, device=device, timings=timings)
    print(json.dumps({k: round(v, 3) for k, v in res.items()}, indent=2), flush=True)
    return res


if __name__ == "__main__":
    main()
