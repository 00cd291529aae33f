"""NuScenes adversarial training of AdversarialCenterPoint (counterpart of robustpointclouds_tpu/cli/train_nuscenes_adversarial.py).

    python -m robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial \
        [--data-root data/nuscenes] [--synthetic] [--max-sweeps 9] [--validate] \
        [--resume] [--pretrained DIR] [--epochs 20] [--batch-size 1] \
        [--steps-per-epoch N] [--steps N] [--tiny] [--seed 0] [--work-dir DIR] [--cpu]

The reference's conservative recipe (batch 1, AdamW lr 5e-5, clip 1.0, 20
epochs, a log line every 20 steps, a checkpoint every 2 epochs, validation
every 2 epochs on 64 val frames) through cli/common.run_training: the
NuScenes loader (multi-sweep points, velocity targets) or, with
--synthetic or when --data-root holds no info pickles, synthetic scenes of
30000 points; the host plan with the CenterHead targets is built in the
prefetch thread. `--pretrained DIR` restores a port checkpoint directory's
newest state (weights and optimizer state, as the JAX CLI does), and a
zoo `.pth` (or a port checkpoint file) the model weights
(train/checkpoint.load_pretrained). `--resume`
restores the work dir's newest checkpoint and goes on at the next epoch.
`--steps N` is a debug run: one epoch of N steps. Runs on the card unless
--cpu. Data parallel through `run(group=...)` (JAX's `run(mesh=...)`), as
cli/train.py's --devices / --multihost reach it: this CLI, as JAX's, takes
no --devices.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="NuScenes adversarial training (PyTorch port)")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--work-dir", default="work_dirs/nuscenes_adversarial_training")
    p.add_argument("--pretrained", default=None,
                   help="port checkpoint dir or zoo .pth to warm-start from")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--data-root", default="data/nuscenes")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--max-sweeps", type=int, default=9)
    p.add_argument("--steps", type=int, default=None,
                   help="debug: one epoch of this many steps")
    p.add_argument("--tiny", action="store_true", help="debug: the 25.6 m smoke grid")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def tiny_centerpoint_cfg(model_cfg, num_points: int = 512):
    """The smoke config of the --tiny flags: CenterPoint's widths on a
    25.6 m grid of 0.4 m voxels (8 x 8 BEV cells), and the frames' points."""
    from ..models.center_detection import CenterHeadConfig
    from ..nn.center_head import NUSCENES_TASKS
    from ..ops.voxelize import VoxelizerConfig

    return model_cfg._replace(
        voxelizer=VoxelizerConfig(point_cloud_range=(-12.8, -12.8, -5.0, 12.8, 12.8, 3.0),
                                  voxel_size=(0.4, 0.4, 0.2), max_points_per_voxel=3,
                                  max_voxels=512),
        head=CenterHeadConfig(tasks=NUSCENES_TASKS,
                              point_cloud_range=(-12.8, -12.8, -5.0, 12.8, 12.8, 3.0),
                              voxel_size=(0.4, 0.4), max_objs=16, nms_pre=64, max_per_task=8),
    ), num_points


def synthetic_nuscenes_loader(batch_size: int, steps_per_epoch: int, num_points: int,
                              max_gt: int, point_range, seed: int = 0):
    """Epoch -> iterator of synthetic (batch, velocities), seeded per epoch
    as the JAX CLI seeds them."""
    from ..data.nuscenes import synthetic_nuscenes_batch

    def epoch_iter(epoch: int):
        rng = np.random.RandomState(seed * 31 + epoch)
        for _ in range(steps_per_epoch):
            yield synthetic_nuscenes_batch(rng, batch_size=batch_size, num_points=num_points,
                                           max_gt=max_gt, point_range=point_range)

    return epoch_iter


def run(cfg=None, work_dir: str = "work_dirs/nuscenes_adversarial_training",
        data_root: str = "data/nuscenes", batch_size: int = 1, max_epochs: int = 20,
        steps_per_epoch: Optional[int] = None, resume: bool = False,
        pretrained: Optional[str] = None, synthetic: bool = False, validate: bool = False,
        tiny: bool = False, max_sweeps: int = 9, seed: int = 0, group=None,
        max_steps: Optional[int] = None, device=None) -> Dict:
    """Programmatic entry (cli/train.py's dispatch for CenterPoint); returns
    cli/common.run_training's result. `cfg`: a core/config.Config whose
    model config (core/builders.build_centerpoint_config) and learning rate
    replace CenterPointConfig() and the recipe's 5e-5, as the JAX entry
    takes them. `group`: a torch.distributed process group to train over,
    data parallel (run_training's), `batch_size` the global batch; rank 0
    alone reads `pretrained`."""
    from ..data.nuscenes import nuscenes_available, nuscenes_epoch_loader, nuscenes_val_loader
    from ..models.centerpoint import CenterPointConfig
    from ..train.centerpoint_loop import CENTERPOINT_TRAIN, CenterPointTrainer
    from ..train.checkpoint import CheckpointManager, load_pretrained
    from .common import run_training

    model_cfg, num_points, lr = CenterPointConfig(), 30000, CENTERPOINT_TRAIN.learning_rate
    if cfg is not None:
        from ..core.builders import build_centerpoint_config, build_train_config

        model_cfg = build_centerpoint_config(cfg)
        lr = build_train_config(cfg).learning_rate
    if tiny:
        model_cfg, num_points = tiny_centerpoint_cfg(model_cfg)
    steps_per_epoch = steps_per_epoch or (max_steps or 500)
    train_cfg = dataclasses.replace(CENTERPOINT_TRAIN, learning_rate=lr, max_epochs=max_epochs,
                                    steps_per_epoch=steps_per_epoch)
    trainer = CenterPointTrainer(model_cfg, train_cfg, device=device)

    if not synthetic and not nuscenes_available(data_root):
        print(f"[data] NuScenes not found under {data_root!r}; using --synthetic", flush=True)
        synthetic = True
    max_gt = model_cfg.head.max_objs
    if synthetic:
        loader = synthetic_nuscenes_loader(batch_size, steps_per_epoch, num_points, max_gt,
                                           model_cfg.voxelizer.point_cloud_range, seed)
        val_loader = None
    else:
        loader = nuscenes_epoch_loader(data_root, batch_size, model_cfg, seed=seed,
                                       steps_per_epoch=steps_per_epoch, num_points=num_points,
                                       max_gt=max_gt, max_sweeps=max_sweeps)

        def val_loader():
            return nuscenes_val_loader(data_root, batch_size, model_cfg, num_points=num_points,
                                       max_gt=max_gt, max_sweeps=max_sweeps, limit=64)

    trainer.init_state(seed)
    if pretrained and (group is None or torch.distributed.get_rank(group) == 0):
        if os.path.isdir(pretrained):
            if CheckpointManager(pretrained).latest_epoch() is not None:
                CheckpointManager(pretrained).restore(trainer)
                print(f"[warm start] restored {pretrained}", flush=True)
            else:
                print(f"[warm start] no checkpoint in {pretrained}; training from scratch "
                      "(the reference needs a pretrained CenterPoint for stability)", flush=True)
        else:
            load_pretrained(trainer, pretrained)
    out = run_training(trainer, loader, work_dir=work_dir,
                       max_epochs=max_epochs if max_steps is None else 1,
                       log_interval=20 if max_steps is None else 1, seed=seed,
                       checkpoint_interval=2, val_interval=2,
                       val_loader=val_loader if validate else None, resume=resume,
                       evaluate=evaluate_centerpoint, group=group)
    print(f"[done] work_dir={work_dir}", flush=True)
    return out


def evaluate_centerpoint(trainer, batches, attack: bool = False,
                         timings: Optional[Dict] = None) -> Dict[str, float]:
    """Score the trainer's model: host plan -> eval forward (the learned
    adversary with its attack bounds when `attack`) -> centerpoint_decode
    (top-k + circle NMS) -> the NuScenes mAP/NDS with velocity and
    attribute errors (eval/nuscenes_metric). `batches` yields batches,
    (batch, velocities) or (batch, velocities, metas); rows whose meta is
    not `valid` are not scored. `timings`, when given, gets per batch the
    host-clock ms of the plan, of the device work up to the detections on
    the host and of the metric's bookkeeping ("batches"), and the metric's
    ms ("metric_ms")."""
    from ..data.nuscenes import NUSCENES_CLASSES
    from ..data.synthetic import PointCloudBatch
    from ..eval.nuscenes_metric import eval_nuscenes_map
    from ..models.center_detection import centerpoint_decode

    plan_builder = trainer.make_plan_builder()
    head = trainer.model_cfg.head
    gts, dts, batch_times = [], [], []
    for item in batches:
        # a bare PointCloudBatch is itself a NamedTuple: test it first
        batch, vel, metas = (item, None, None) if isinstance(item, PointCloudBatch) else (
            *item, None)[:3]
        t0 = time.perf_counter()
        plan = plan_builder(batch.points, batch.points_mask)
        t1 = time.perf_counter()
        outs = trainer.forward_eval(plan, attack=attack)
        with torch.no_grad():
            boxes, scores, labels, mask = (t.cpu().numpy() for t in
                                           centerpoint_decode(outs.task_preds, head))
        t2 = time.perf_counter()
        for b in range(batch.points.shape[0]):
            if metas is not None and not metas[b].get("valid", True):
                continue
            gm = np.asarray(batch.gt_mask[b])
            gt = {"boxes_3d": np.asarray(batch.gt_boxes[b])[gm],
                  "labels": np.asarray(batch.gt_labels[b])[gm]}
            if vel is not None:
                gt["vel"] = np.asarray(vel[b])[gm]
            if metas is not None and metas[b].get("gt_attrs") is not None:
                gt["attrs"] = np.asarray(metas[b]["gt_attrs"])[gm]
            gts.append(gt)
            dm = mask[b]
            dts.append({"boxes_3d": boxes[b][dm], "labels": labels[b][dm],
                        "score": scores[b][dm]})
        batch_times.append({"plan_ms": (t1 - t0) * 1e3, "device_ms": (t2 - t1) * 1e3,
                            "metric_ms": (time.perf_counter() - t2) * 1e3})
    t0 = time.perf_counter()
    results = eval_nuscenes_map(gts, dts, NUSCENES_CLASSES)
    if timings is not None:
        timings["batches"] = batch_times
        timings["metric_ms"] = (time.perf_counter() - t0) * 1e3
    return results


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the CLI; returns run()'s result."""
    from ..core.device import resolve_device

    args = parse_args(argv)
    return run(work_dir=args.work_dir, data_root=args.data_root, batch_size=args.batch_size,
               max_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch, resume=args.resume,
               pretrained=args.pretrained, synthetic=args.synthetic, validate=args.validate,
               tiny=args.tiny, max_sweeps=args.max_sweeps, seed=args.seed,
               max_steps=args.steps, device=resolve_device("cpu" if args.cpu else None))


if __name__ == "__main__":
    main()
