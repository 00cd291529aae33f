"""KITTI 3-class adversarial training entry point (counterpart of robustpointclouds_tpu/cli/train_kitti_3class_adversarial.py).

    python -m robustpointclouds_tpu_torch.cli.train_kitti_3class_adversarial \
        --synthetic [--tiny] [--steps N] [--epochs N] [--batch-size 6] \
        [--seed 0] [--work-dir DIR] [--cpu]

The reference recipe (batch 6, the VoxelNetConfig / TrainConfig defaults) on
synthetic scenes. `--steps N` is a debug run: one epoch of N steps, logging
every step. Checkpoints (train/checkpoint.py) go to --work-dir every 5
epochs and after the last; the evaluation CLIs score them. Runs on the card
unless `--cpu`. Every other flag of the JAX
CLI (the KITTI loader, --validate, --resume, --freeze-detector, --load-from,
--devices, --amp, --profile, --config, --cfg-options, ...) raises "not
ported yet".
"""
from __future__ import annotations

import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="KITTI 3-class adversarial training (PyTorch port)")
    p.add_argument("--work-dir", default="work_dirs/kitti_3class_adversarial_torch")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=6)
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic scenes (the only data source ported)")
    p.add_argument("--steps", type=int, default=None,
                   help="debug: one epoch of this many steps, logging every step")
    p.add_argument("--tiny", action="store_true", help="debug: the 16 m smoke grid")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--seed", type=int, default=0)
    args, unknown = p.parse_known_args(argv)
    if unknown:
        raise SystemExit(f"train_kitti_3class_adversarial: {' '.join(unknown)}: not ported yet")
    if not args.synthetic:
        raise SystemExit("train_kitti_3class_adversarial: the KITTI loader is not ported yet; "
                         "pass --synthetic")
    return args


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    from ..models.voxelnet import VoxelNetConfig
    from ..train.loop import TrainConfig, Trainer
    from .common import run_training, synthetic_loader, tiny_voxelnet_cfg

    model_cfg = tiny_voxelnet_cfg() if args.tiny else VoxelNetConfig()
    num_points = 512 if args.tiny else 20000
    steps_per_epoch = args.steps or 1000
    train_cfg = TrainConfig(max_epochs=args.epochs, steps_per_epoch=steps_per_epoch)
    trainer = Trainer(model_cfg, train_cfg, device="cpu" if args.cpu else None)
    loader = synthetic_loader(args.batch_size, steps_per_epoch, num_points=num_points,
                              seed=args.seed, point_range=model_cfg.voxelizer.point_cloud_range)
    out = run_training(trainer, loader, work_dir=args.work_dir,
                       max_epochs=args.epochs if args.steps is None else 1,
                       log_interval=50 if args.steps is None else 1, seed=args.seed)
    print(f"[done] work_dir={out['work_dir']}", flush=True)
    return out


if __name__ == "__main__":
    main()
