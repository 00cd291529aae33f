"""NuScenes evaluation of CenterPoint: baseline / clean / adversarial (counterpart of robustpointclouds_tpu/cli/evaluate_nuscenes_adversarial.py).

    python -m robustpointclouds_tpu_torch.cli.evaluate_nuscenes_adversarial \
        [--mode baseline|clean|adversarial|all] [--checkpoint DIR] [--work-dir DIR] \
        [--baseline-dir DIR] [--data-root data/nuscenes] [--batch-size 1] \
        [--synthetic] [--frames 8] [--limit N] [--pretrained DIR] \
        [--allow-random-init] [--tiny] [--cpu]

The reference's mode surface: 'baseline' scores a non-adversarial
checkpoint (--baseline-dir), 'clean' the adversarially trained model with
perturbations off and 'adversarial' the same model under the learned
adversary's attack bounds (--checkpoint or --work-dir), each with the
SUCCESS/FAILED summary. Scores are the self-contained NuScenes mAP/NDS
(eval/nuscenes_metric) over the val split's frames (--limit caps them) or,
with --synthetic or without info pickles under --data-root, over --frames
synthetic scenes, whose every result key then carries the `SYNTHETIC_`
prefix. A work dir without a checkpoint falls back to --pretrained (a port
checkpoint or a zoo `.pth`) or, with --allow-random-init, to a random init. Runs on the
card unless --cpu; without a card and without --cpu it raises.
"""
from __future__ import annotations

import argparse
import json
import traceback
from typing import Dict, List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="NuScenes adversarial evaluation (PyTorch port)")
    p.add_argument("--mode", choices=("baseline", "clean", "adversarial", "all"), default="all")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--work-dir", default="work_dirs/nuscenes_adversarial_training")
    p.add_argument("--baseline-dir", default="work_dirs/nuscenes_baseline")
    p.add_argument("--data-root", default="data/nuscenes")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--frames", type=int, default=8, help="synthetic val frames")
    p.add_argument("--limit", type=int, default=None,
                   help="cap on real val frames (default: full split)")
    p.add_argument("--pretrained", default=None,
                   help="port checkpoint or zoo .pth scored when the work dir is empty")
    p.add_argument("--allow-random-init", action="store_true",
                   help="score an untrained model (smoke runs only)")
    return p.parse_args(argv)


def evaluate(work_dir: str, args, attack: bool, device=None,
             timings: Optional[Dict] = None) -> Dict[str, float]:
    """Restore the newest checkpoint of `work_dir` (else --pretrained, else a
    random init when allowed) and score it (evaluate_centerpoint)."""
    from ..data.nuscenes import nuscenes_available, nuscenes_val_loader, synthetic_nuscenes_batch
    from ..models.centerpoint import CenterPointConfig
    from ..train.centerpoint_loop import CenterPointTrainer
    from ..train.checkpoint import CheckpointManager, load_pretrained
    from ..train.loop import TrainConfig
    from .train_nuscenes_adversarial import evaluate_centerpoint, tiny_centerpoint_cfg

    model_cfg, num_points = CenterPointConfig(), 30000
    if args.tiny:
        model_cfg, num_points = tiny_centerpoint_cfg(model_cfg)
    trainer = CenterPointTrainer(model_cfg, TrainConfig(), device=device)
    max_gt = model_cfg.head.max_objs
    use_synth = args.synthetic or not nuscenes_available(args.data_root)
    if use_synth:
        rng = np.random.RandomState(777)
        batches = [synthetic_nuscenes_batch(rng, batch_size=args.batch_size,
                                            num_points=num_points, max_gt=max_gt,
                                            point_range=model_cfg.voxelizer.point_cloud_range)
                   for _ in range(max(args.frames // args.batch_size, 1))]
    else:
        batches = nuscenes_val_loader(args.data_root, args.batch_size, model_cfg,
                                      num_points=num_points, max_gt=max_gt, limit=args.limit)

    trainer.init_state(0)
    ckpt = CheckpointManager(work_dir)
    if ckpt.latest_epoch() is not None:
        try:
            ckpt.restore(trainer)
        except RuntimeError as e:
            raise RuntimeError(f"checkpoint in {work_dir!r} does not match the evaluated model "
                               f"(e.g. a --tiny smoke run wrote it): {e}") from e
        print(f"[eval] restored epoch {ckpt.latest_epoch()} from {work_dir}", flush=True)
    elif getattr(args, "pretrained", None):
        load_pretrained(trainer, args.pretrained)
        print(f"[eval] warm start from {args.pretrained}", flush=True)
    elif getattr(args, "allow_random_init", False):
        print(f"[warn] no checkpoint in {work_dir}; evaluating RANDOM INIT "
              "(--allow-random-init)", flush=True)
    else:
        raise FileNotFoundError(f"no checkpoint in {work_dir!r} and no --pretrained given; "
                                "refusing to score a random init (--allow-random-init for smoke)")

    metrics = evaluate_centerpoint(trainer, batches, attack=attack, timings=timings)
    if use_synth:
        # a synthetic-scene score must never read as a real NuScenes number
        metrics = {f"SYNTHETIC_{k}": v for k, v in metrics.items()}
    return metrics


def main(argv: Optional[List[str]] = None, timings: Optional[Dict] = None):
    """Run the CLI; `timings`, when given, gets each mode's evaluation
    timings (evaluate_centerpoint) under the mode's name."""
    from ..core.device import resolve_device

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    modes = (("baseline", args.baseline_dir, False),
             ("clean", args.checkpoint or args.work_dir, False),
             ("adversarial", args.checkpoint or args.work_dir, True))
    results = {}
    for name, wd, attack in modes:
        if args.mode not in ("all", name):
            continue
        print("=" * 60 + f"\n{name.upper()} EVALUATION\n" + "=" * 60, flush=True)
        t = {} if timings is not None else None
        try:
            results[name] = evaluate(wd, args, attack, device=device, timings=t)
            print(json.dumps({k: round(v, 3) for k, v in results[name].items()}, indent=2),
                  flush=True)
        except Exception as e:  # noqa: BLE001 - the reference's per-mode SUCCESS/FAILED table
            traceback.print_exc()
            print(f"[{name}] FAILED: {e}", flush=True)
            results[name] = None
        if timings is not None:
            timings[name] = t

    print("\n" + "=" * 60 + "\nSUMMARY")
    for name, res in results.items():
        extra = ""
        if res:
            synth = any(k.startswith("SYNTHETIC_") for k in res)
            pre = "SYNTHETIC_" if synth else ""
            extra = (f" mAP={res[pre + 'mAP']:.2f} NDS={res[pre + 'NDS']:.2f}"
                     + (" [SYNTHETIC DATA]" if synth else ""))
        print(f"  {name}: {'SUCCESS' if res is not None else 'FAILED'}{extra}", flush=True)
    return results


if __name__ == "__main__":
    main()
