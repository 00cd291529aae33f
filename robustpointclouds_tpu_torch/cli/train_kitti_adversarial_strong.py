"""Strong-perturbation KITTI adversarial training and its progress dashboard (counterpart of robustpointclouds_tpu/cli/train_kitti_adversarial_strong.py).

    python -m robustpointclouds_tpu_torch.cli.train_kitti_adversarial_strong \
        [--data-root data/kitti] [--synthetic] [--validate] [--val-limit N] \
        [--epochs 10] [--batch-size 1] [--steps-per-epoch N] [--steps N] \
        [--tiny] [--seed 0] [--work-dir DIR] [--cpu]

The reference recipe (train_kitti_adversarial_strong.py): batch 1, 10
epochs, validation every 2 epochs, the StrongVoxelPerturber with dynamic
scaling and momentum, then the attack-progress analysis
(`AdversarialProgressMonitor`: the strength-retention verdict, recent /
initial adversarial loss >= 0.8 => sustained). The model config is
StrongVoxelNetConfig's defaults on the SECOND base (no config file, as in
JAX); `--tiny` puts it on the 16 m smoke grid with an adversary of (16, 32).
Each epoch resets the momentum carry and updates the dynamic scale; every
10th step (and the first) is logged, feeds the scale's history and consults
the NaN ladder (which re-initialises the adversary). A checkpoint every 2
epochs and after the last; with --validate, the KITTI AP every 2 epochs,
the best `mAP_3d_moderate` kept as best.pt, and `val_history.json`. The
dashboard is written as CSV / JSON, and as a PNG where matplotlib imports.
Data: the KITTI layout under --data-root (data/kitti.kitti_epoch_loader),
or synthetic scenes with --synthetic or when --data-root holds no KITTI
layout (no validation then). Runs on the card unless --cpu.

As in the JAX package, `cli/train.py` on
configs/adversarial/adversarial-second_strong.py trains the plain
AdversarialVoxelNet (core/builders maps StrongAdversarialVoxelNet to a
VoxelNetConfig); only this entry point trains the strong model.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time
from typing import Dict, List, Optional


class AdversarialProgressMonitor:
    """Tracks the adversary's strength across training (reference :69-173)."""

    def __init__(self):
        self.history: List[Dict[str, float]] = []  # per-log dicts

    def record(self, epoch: int, step: int, logs: Dict) -> None:
        self.history.append({"epoch": epoch, "step": step,
                             **{k: float(v) for k, v in logs.items()}})

    def strength_retention(self) -> float:
        adv = [abs(h.get("loss_adversarial", 0.0)) for h in self.history]
        if len(adv) < 4:
            return 1.0
        k = max(len(adv) // 4, 1)
        initial = sum(adv[:k]) / k
        recent = sum(adv[-k:]) / k
        return recent / max(initial, 1e-9)

    def verdict(self) -> str:
        r = self.strength_retention()
        return (f"ATTACK {'SUCCESSFUL — sustained' if r >= 0.8 else 'WEAKENED'} "
                f"(strength retention {r:.2f}, threshold 0.8)")

    def save(self, work_dir: str) -> str:
        path = os.path.join(work_dir, "adversarial_progress.csv")
        if self.history:
            # the validation rows carry other keys than the training logs (the
            # JAX monitor takes the first row's keys, which a validated run's
            # rows overflow)
            fields = sorted({k for h in self.history for k in h})
            with open(path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields)
                w.writeheader()
                w.writerows(self.history)
        with open(os.path.join(work_dir, "adversarial_progress.json"), "w") as f:
            json.dump({"history": self.history, "strength_retention": self.strength_retention(),
                       "verdict": self.verdict()}, f, indent=2)
        self._plot(work_dir)
        return path

    def _plot(self, work_dir: str) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return  # no matplotlib: the CSV / JSON dashboards suffice
        if not self.history:
            return
        fig, axes = plt.subplots(2, 2, figsize=(12, 8))
        xs = list(range(len(self.history)))
        panels = [("loss_adversarial", "Adversarial loss"), ("loss_cls", "Classification loss"),
                  ("perturbation_l2_norm", "Perturbation L2"),
                  ("attack_scale", "Dynamic attack scale")]
        for ax, (key, title) in zip(axes.ravel(), panels):
            ax.plot(xs, [h.get(key, 0.0) for h in self.history])
            ax.set_title(title)
            ax.grid(alpha=0.3)
        fig.suptitle(self.verdict())
        fig.tight_layout()
        fig.savefig(os.path.join(work_dir, "adversarial_progress.png"), dpi=100)
        plt.close(fig)


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Strong KITTI adversarial training (PyTorch port)")
    p.add_argument("--work-dir", default="work_dirs/kitti_adversarial_strong_torch")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--data-root", default="data/kitti")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--validate", action="store_true",
                   help="KITTI AP validation every 2 epochs (reference :219-232)")
    p.add_argument("--val-limit", type=int, default=None, help="cap on validation frames")
    p.add_argument("--steps", type=int, default=None,
                   help="debug: one epoch of at most this many steps")
    p.add_argument("--tiny", action="store_true", help="debug: the 16 m smoke grid")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--seed", type=int, default=0)
    from .common import parse_ported_args

    return parse_ported_args(p, argv, "train_kitti_adversarial_strong")


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the CLI; returns the trainer, the validation history, the monitor,
    the plan builds' timings and each epoch's seconds and frames/s."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from ..data.kitti import kitti_available, kitti_epoch_loader, kitti_val_loader
    from ..data.synthetic import synthetic_kitti_batch
    from ..models.strong import StrongVoxelNetConfig
    from ..models.voxelnet import VoxelNetConfig
    from ..train.checkpoint import CheckpointManager
    from ..train.hooks import NaNLadder, reinit_adversary_params
    from ..train.loop import TrainConfig
    from ..train.strong_loop import StrongTrainer
    from .common import prefetch_iterator, run_evaluation, tiny_voxelnet_cfg, with_plans

    base = VoxelNetConfig(adversary=None)
    num_points = 20000
    if args.tiny:
        tiny = tiny_voxelnet_cfg()
        base = base._replace(voxelizer=tiny.voxelizer, anchor_ranges=tiny.anchor_ranges)
        num_points = 512
    model_cfg = StrongVoxelNetConfig(base=base)
    if args.tiny:
        model_cfg = model_cfg._replace(perturber={**model_cfg.perturber,
                                                  "hidden_channels": (16, 32)})
    steps_per_epoch = args.steps_per_epoch or (args.steps or 500)
    trainer = StrongTrainer(model_cfg,
                            TrainConfig(max_epochs=args.epochs, steps_per_epoch=steps_per_epoch),
                            device="cpu" if args.cpu else None)
    pcr = base.voxelizer.point_cloud_range

    # real KITTI when present (the reference trains on the real dataset);
    # synthetic only as the fallback or on --synthetic
    use_synth = args.synthetic
    if not use_synth and not kitti_available(args.data_root):
        print(f"[data] KITTI not found under {args.data_root!r}; "
              "falling back to --synthetic scenes", flush=True)
        use_synth = True
    val_loader = None
    if use_synth:
        def batches(epoch):
            rng = np.random.RandomState(args.seed * 17 + epoch)
            for _ in range(steps_per_epoch):
                yield synthetic_kitti_batch(rng, batch_size=args.batch_size,
                                            num_points=num_points, point_range=pcr)
    else:
        batches = kitti_epoch_loader(args.data_root, args.batch_size, base, seed=args.seed,
                                     steps_per_epoch=args.steps_per_epoch, num_points=num_points)
        if args.validate:
            def val_loader():
                return kitti_val_loader(args.data_root, args.batch_size, base,
                                        num_points=num_points, limit=args.val_limit)

    os.makedirs(args.work_dir, exist_ok=True)
    monitor = AdversarialProgressMonitor()
    ladder = NaNLadder()
    ckpt = CheckpointManager(args.work_dir, save_interval_epochs=2)
    state = trainer.init_state(args.seed, batch_size=args.batch_size)
    reinit_gen = torch.Generator().manual_seed(args.seed)
    # host plans built in the prefetch thread (cli/common.run_training), by
    # one builder for the whole run
    plan_builder = trainer.make_plan_builder()
    val_history: Dict = {}
    epochs: List[Dict] = []
    max_epochs = args.epochs if args.steps is None else 1
    for epoch in range(max_epochs):
        state = trainer.update_dynamic_scaling(state, epoch)
        state = trainer.reset_momentum(state)  # the reference resets between epochs
        t0, n_frames = time.time(), 0
        it = prefetch_iterator(with_plans(plan_builder, batches(epoch)))
        try:
            for i, (batch, plan) in enumerate(it):
                logs = trainer.train_step(batch, epoch, plan)
                n_frames += batch.points.shape[0]
                if (i + 1) % 10 == 0 or i == 0:
                    monitor.record(epoch, i, logs)
                    state = trainer.update_dynamic_scaling(state, epoch, logs)
                    ladder.update(state, adversary_reinit_fn=lambda: reinit_adversary_params(
                        trainer.model.adversary, reinit_gen))
                    print(f"[epoch {epoch} iter {i + 1}] " + " ".join(
                        f"{k}={float(v):.4f}" for k, v in sorted(logs.items())), flush=True)
                    if ladder.should_stop:
                        break
                if args.steps and i + 1 >= args.steps:
                    break
        finally:
            it.close()
        dt = time.time() - t0
        epochs.append({"epoch": epoch, "s": dt, "frames": n_frames,
                       "frames_per_s": n_frames / max(dt, 1e-9)})
        ckpt.maybe_save(epoch, trainer)
        # validation every 2 epochs (reference train_kitti_adversarial_strong.py:219-232)
        if val_loader is not None and (epoch + 1) % 2 == 0:
            metrics = run_evaluation(trainer, val_loader())
            val_history[f"val_epoch{epoch}"] = metrics
            key = "mAP_3d_moderate"
            if key in metrics and ckpt.save_best(metrics[key], trainer, epoch):
                print(f"[ckpt] new best {key}={metrics[key]:.2f} (epoch {epoch})", flush=True)
            monitor.record(epoch, -1, {f"val_{k}": v for k, v in metrics.items()
                                       if isinstance(v, (int, float))})
            print(f"[val epoch {epoch}] {metrics}", flush=True)
        if ladder.should_stop:
            print("[NaN ladder] stopping", flush=True)
            break
    ckpt.save(max_epochs - 1, trainer)
    monitor.save(args.work_dir)
    if val_history:
        with open(os.path.join(args.work_dir, "val_history.json"), "w") as f:
            json.dump(val_history, f, indent=2)
    print(monitor.verdict(), flush=True)
    print(f"[done] work_dir={args.work_dir}", flush=True)
    return {"trainer": trainer, "history": val_history, "monitor": monitor,
            "work_dir": args.work_dir, "plans": list(plan_builder.timings), "epochs": epochs}


if __name__ == "__main__":
    main()
