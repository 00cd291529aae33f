"""KITTI 3-class adversarial training entry point (counterpart of robustpointclouds_tpu/cli/train_kitti_3class_adversarial.py).

    python -m robustpointclouds_tpu_torch.cli.train_kitti_3class_adversarial \
        [--config FILE] [--cfg-options k=v ...] [--data-root data/kitti] \
        [--synthetic] [--validate] [--resume] [--freeze-detector] \
        [--load-from CKPT] [--profile DIR] [--epochs N] [--steps-per-epoch N] \
        [--batch-size 6] [--devices N] [--tiny] [--steps N] [--seed 0] [--work-dir DIR] [--cpu] \
        [--amp]

The reference recipe (batch 6, 20 epochs, validation every `val_interval`
epochs of the config, a checkpoint every 5 epochs, the newest 10 kept). The
model and train configs are built from the config file
(configs/adversarial/adversarial-second_kitti-3d-3class.py by default, a
path from the working directory), so `--cfg-options` dotted overrides
really change them; `pgd_adversary.steps=K` turns on PGD adversarial
training. `--freeze-detector` trains the adversary alone: detector learning
off, adversary lr x20, adversarial weight 0.5, regularisation 1e-5, the
adversary on from epoch 0. Data: the KITTI layout under --data-root through
data/kitti.kitti_epoch_loader (native IO + augmentation + GT-paste), or
synthetic scenes with --synthetic or when --data-root holds no KITTI layout.
`--steps N` is a debug run: one epoch of N steps, logging every step.
`--load-from` warm-starts from a port checkpoint or an mmdet3d zoo `.pth`
(train/checkpoint.load_pretrained). Runs on the card unless --cpu.
`--devices N` trains data parallel (cli/common.run_training's `group`): N
spawned ranks, one a card (cuda:0..N-1, NCCL) or, with --cpu, N CPU
processes (gloo), each on batch_size / N rows of every batch; JAX's
refusals: more than the attached cards, a --batch-size N does not divide.
`--amp` sets bfloat16 matmul precision for the float32 dense work while
the CLI runs (cli/common.amp_precision; K1's float32 route stays 3xTF32).
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

DEFAULT_CONFIG = os.path.join("configs", "adversarial", "adversarial-second_kitti-3d-3class.py")


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="KITTI 3-class adversarial training (PyTorch port)")
    p.add_argument("--config", default=DEFAULT_CONFIG,
                   help="config file (default: the 3-class adversarial config)")
    p.add_argument("--validate", action="store_true", help="run validation during training")
    p.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    p.add_argument("--freeze-detector", action="store_true",
                   help="freeze the detector, train the adversary only (lr x20, w=0.5, reg=1e-5)")
    p.add_argument("--load-from", default=None, help="warm start from a port checkpoint or a zoo .pth")
    p.add_argument("--work-dir", default="work_dirs/kitti_3class_adversarial_torch")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=6)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="override steps per epoch (default: dataset size)")
    p.add_argument("--data-root", default="data/kitti")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic scenes (no dataset required)")
    p.add_argument("--steps", type=int, default=None,
                   help="debug: one epoch of this many steps, logging every step")
    p.add_argument("--tiny", action="store_true", help="debug: the 16 m smoke grid")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of steps 10-13")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg-options", nargs="*", default=[], help="dotted config overrides key=value")
    from .common import AMP_HELP, add_data_parallel_args, parse_ported_args

    p.add_argument("--amp", action="store_true", help=AMP_HELP)

    add_data_parallel_args(p, multihost=False)
    args = parse_ported_args(p, argv, "train_kitti_3class_adversarial")
    if not os.path.isfile(args.config):
        raise SystemExit(f"train_kitti_3class_adversarial: no config file {args.config!r}")
    return args


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the CLI; returns run_training's result (rank 0's, without the
    train state, for --devices N)."""
    import sys

    from . import common

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    with common.amp_precision(args.amp):
        if args.devices and args.devices > 1:
            common.check_devices(args.devices, args.batch_size, args.cpu, "--batch-size")
            return common.launch_devices(_devices_rank, args.devices, argv, args.cpu,
                                         args.work_dir)[0]
        return train(args)


def _devices_rank(rank: int, world: int, argv: List[str]) -> Dict:
    """One rank of --devices N (parallel/multihost.launch_local)."""
    import torch.distributed

    from .common import amp_precision, picklable_result

    args = parse_args(argv)
    with amp_precision(args.amp):
        return picklable_result(train(args, torch.distributed.group.WORLD))


def train(args, group=None) -> Dict:
    """Train as the parsed `args` ask, data parallel over `group`."""
    from ..core.builders import build_train_config, build_voxelnet_config
    from ..core.config import Config
    from ..data.kitti import kitti_available, kitti_epoch_loader, kitti_val_loader
    from ..train.loop import Trainer
    from .common import run_training, synthetic_loader, tiny_voxelnet_cfg

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_cli(args.cfg_options)
    model_cfg = build_voxelnet_config(cfg)
    num_points = 20000
    if args.tiny:
        tiny = tiny_voxelnet_cfg()
        model_cfg = model_cfg._replace(voxelizer=tiny.voxelizer, anchor_ranges=tiny.anchor_ranges)
        num_points = 512
    steps_per_epoch = args.steps_per_epoch or (args.steps or 1000)
    overrides = dict(max_epochs=args.epochs, steps_per_epoch=steps_per_epoch)
    if args.freeze_detector:
        # the reference's freeze mode: detector lr off, adversary lr_mult 20,
        # adversarial weight 0.5, regularisation 1e-5, the adversary from epoch 0
        overrides.update(adversary_lr_mult=20.0, adversarial_loss_weight=0.5,
                         regularization_weight=1e-5, freeze_detector=True)
        model_cfg = model_cfg._replace(adversary_start_epoch=0)
    train_cfg = build_train_config(cfg, **overrides)
    trainer = Trainer(model_cfg, train_cfg, device="cpu" if args.cpu else None)

    if not args.synthetic and not kitti_available(args.data_root):
        print(f"[data] KITTI not found under {args.data_root!r}; "
              "falling back to --synthetic scenes", flush=True)
        args.synthetic = True
    pcr = model_cfg.voxelizer.point_cloud_range
    if args.synthetic:
        loader = synthetic_loader(args.batch_size, steps_per_epoch, num_points=num_points,
                                  seed=args.seed, point_range=pcr)

        def val_loader():
            return synthetic_loader(args.batch_size, 4, num_points=num_points,
                                    seed=args.seed + 999, point_range=pcr)(0)
    else:
        # KITTI frames keep the loader's 20000-point padding, --tiny or not
        loader = kitti_epoch_loader(args.data_root, args.batch_size, model_cfg, seed=args.seed,
                                    steps_per_epoch=args.steps_per_epoch or args.steps)

        def val_loader():
            return kitti_val_loader(args.data_root, args.batch_size, model_cfg)

    out = run_training(trainer, loader, work_dir=args.work_dir,
                       max_epochs=args.epochs if args.steps is None else 1,
                       val_interval=int(cfg.get("val_interval", 5)),
                       val_loader=val_loader if args.validate else None, resume=args.resume,
                       log_interval=50 if args.steps is None else 1, checkpoint_interval=5,
                       max_keep=10, seed=args.seed, profile_dir=args.profile,
                       load_from=args.load_from or cfg.get("load_from"), group=group)
    print(f"[done] work_dir={out['work_dir']}", flush=True)
    return out


if __name__ == "__main__":
    main()
