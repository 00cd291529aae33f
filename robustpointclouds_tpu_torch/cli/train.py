"""Generic config-driven training entry point (counterpart of robustpointclouds_tpu/cli/train.py).

    python -m robustpointclouds_tpu_torch.cli.train CONFIG [--work-dir DIR] \
        [--resume] [--load-from CKPT] [--synthetic] [--validate] \
        [--steps-per-epoch N] [--seed 0] [--auto-scale-lr] [--cpu] \
        [--devices N | --multihost [--coordinator HOST:PORT] [--num-processes N] \
        [--process-id I]] [--amp] [--cfg-options k=v ...]

Builds the model named by `model.type` through the config file
(core/builders.build_model_config; `--cfg-options` dotted overrides change
the built model) and trains it:
  * AdversarialCenterPoint goes to cli/train_nuscenes_adversarial.run with
    the config (NuScenes loader, or synthetic scenes);
  * AdversarialVoxelNet (SECOND) and AdversarialPointPillars go through
    train/loop.Trainer and cli/common.run_training, on the KITTI epoch
    loader under the config's `data_root`, or on synthetic scenes in the
    config's point range with --synthetic or when no KITTI layout is there.
`batch_size`, `max_epochs`, `val_interval`, `work_dir`, `data_root`,
`load_from` and `auto_scale_lr.base_batch_size` come from the config.
`--auto-scale-lr` scales the learning rate by batch_size * max(devices, 1)
/ base_batch_size, as JAX's does (the global batch stays `batch_size`).
`--load-from` (or the config's `load_from`) takes a port checkpoint or an
mmdet3d zoo `.pth` (train/checkpoint.load_pretrained). Runs on the card
unless --cpu.

Data parallel (cli/common.run_training's `group`), for every family:
`--devices N` spawns N ranks on this machine (cuda:0..N-1 over NCCL; with
--cpu, N CPU processes over gloo), each on batch_size / N rows of every
batch; `--multihost` makes this process one rank of a multi-process job
(torchrun's environment, or JAX's --coordinator / --num-processes /
--process-id), one card a process. JAX's refusals: more --devices than
attached cards, a batch_size the ranks do not divide. `--amp` sets
bfloat16 matmul precision for the float32 dense work while the CLI runs
(cli/common.amp_precision; K1's float32 route stays 3xTF32).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Train a detector from a config file (PyTorch port)")
    p.add_argument("config", help="config python file")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume", nargs="?", const="auto", default=None,
                   help="resume from the work dir's newest checkpoint")
    p.add_argument("--load-from", default=None, help="warm start from a port checkpoint or a zoo .pth")
    p.add_argument("--auto-scale-lr", action="store_true",
                   help="scale lr by batch_size / auto_scale_lr.base_batch_size")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic scenes even if the dataset exists")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--cfg-options", nargs="*", default=[])
    from .common import AMP_HELP, add_data_parallel_args, parse_ported_args

    p.add_argument("--amp", action="store_true", help=AMP_HELP)

    add_data_parallel_args(p)
    return parse_ported_args(p, argv, "train")


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the CLI; returns run_training's result (rank 0's, without the
    train state, for --devices N)."""
    import sys

    from . import common

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    cfg = _config(args)
    batch_size = int(cfg.get("batch_size", 6))
    with common.amp_precision(args.amp):
        if args.multihost:
            group = _join_multihost(args, batch_size)
            try:
                return train(args, cfg, group)
            finally:
                torch.distributed.destroy_process_group()
        if args.devices and args.devices > 1:
            common.check_devices(args.devices, batch_size, args.cpu, "batch_size")
            work_dir = args.work_dir or cfg.get("work_dir", "work_dirs/train")
            return common.launch_devices(_devices_rank, args.devices, argv, args.cpu,
                                         work_dir)[0]
        return train(args, cfg)


def _join_multihost(args, batch_size: int):
    """--multihost: pick this process's card (LOCAL_RANK), join the process
    group (NCCL on the card, gloo with --cpu) and refuse a batch the world
    does not divide -> the group (the default one)."""
    from ..parallel.multihost import init_multihost, local_device_index

    if not args.cpu:
        torch.cuda.set_device(local_device_index())
    pid, nproc = init_multihost(args.coordinator, args.num_processes, args.process_id,
                                backend="gloo" if args.cpu else "nccl")
    if batch_size % nproc:
        torch.distributed.destroy_process_group()
        raise SystemExit(f"batch_size {batch_size} not divisible by the {nproc} global devices")
    print(f"[multihost] process {pid}/{nproc}, {torch.distributed.get_backend()}", flush=True)
    return torch.distributed.group.WORLD


def _devices_rank(rank: int, world: int, argv: List[str]) -> Dict:
    """One rank of --devices N (parallel/multihost.launch_local)."""
    from .common import amp_precision, picklable_result

    args = parse_args(argv)
    with amp_precision(args.amp):
        return picklable_result(train(args, _config(args), torch.distributed.group.WORLD))


def _config(args):
    from ..core.config import Config

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_cli(args.cfg_options)
    return cfg


def train(args, cfg, group=None) -> Dict:
    """Build the config's model and train it, data parallel over `group`."""
    from ..core.builders import build_model_config, build_train_config

    work_dir = args.work_dir or cfg.get("work_dir", "work_dirs/train")
    model_type = cfg.get("model", {}).get("type", "AdversarialVoxelNet")
    batch_size = int(cfg.get("batch_size", 6))
    max_epochs = int(cfg.get("max_epochs", 20))
    val_interval = int(cfg.get("val_interval", 5))
    data_root = cfg.get("data_root", "data/kitti")
    load_from = args.load_from or cfg.get("load_from")
    device = "cpu" if args.cpu else None

    if model_type in ("AdversarialCenterPoint", "CenterPoint"):
        # CenterPoint runs through its own trainer (another loss and evaluation)
        from .train_nuscenes_adversarial import run as nus_run

        return nus_run(cfg=cfg, work_dir=work_dir, data_root=data_root, batch_size=batch_size,
                       max_epochs=max_epochs, resume=bool(args.resume), pretrained=load_from,
                       synthetic=args.synthetic, validate=args.validate, seed=args.seed,
                       steps_per_epoch=args.steps_per_epoch, device=device, group=group)

    from ..data.kitti import kitti_available, kitti_epoch_loader, kitti_val_loader
    from ..train.loop import Trainer
    from .common import run_training, synthetic_loader

    model_cfg = build_model_config(cfg)
    steps_per_epoch = args.steps_per_epoch
    train_cfg = build_train_config(cfg, steps_per_epoch=steps_per_epoch or 1000,
                                   max_epochs=max_epochs)
    if args.auto_scale_lr:
        base_bs = int(cfg.get("auto_scale_lr", {}).get("base_batch_size", 48))
        # JAX's factor: the device count multiplies a batch_size that is
        # already the global batch (ROADMAP.md §3)
        scale = batch_size * max(args.devices or 1, 1) / base_bs
        train_cfg = dataclasses.replace(train_cfg,
                                        learning_rate=train_cfg.learning_rate * scale)
        print(f"[auto-scale-lr] x{scale:.3f} -> lr {train_cfg.learning_rate:.2e}", flush=True)
    trainer = Trainer(model_cfg, train_cfg, device=device)

    use_synth = args.synthetic
    if not use_synth and not kitti_available(data_root):
        print(f"[data] KITTI not found under {data_root!r}; falling back to synthetic scenes",
              flush=True)
        use_synth = True
    if use_synth:
        pcr = model_cfg.voxelizer.point_cloud_range
        loader = synthetic_loader(batch_size, steps_per_epoch or 100, seed=args.seed,
                                  point_range=pcr)

        def val_loader():
            return synthetic_loader(batch_size, 4, seed=args.seed + 999, point_range=pcr)(0)
    else:
        loader = kitti_epoch_loader(data_root, batch_size, model_cfg, seed=args.seed,
                                    steps_per_epoch=steps_per_epoch)

        def val_loader():
            return kitti_val_loader(data_root, batch_size, model_cfg)

    out = run_training(trainer, loader, work_dir=work_dir, max_epochs=max_epochs,
                       val_interval=val_interval,
                       val_loader=val_loader if args.validate else None,
                       resume=bool(args.resume), seed=args.seed, load_from=load_from,
                       group=group)
    print(f"[done] work_dir={out['work_dir']}", flush=True)
    return out


if __name__ == "__main__":
    main()
