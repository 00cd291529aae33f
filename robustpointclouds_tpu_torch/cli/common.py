"""Shared CLI machinery: the training driver and metric logging (counterpart of robustpointclouds_tpu/cli/common.py).

One explicit loop: data -> host plan in the prefetch thread -> train step
-> NaN ladder at log boundaries, with the perturbation-metrics CSV dump
matching the reference's `save_l2_norms` schema (voxel_perturber.py:411-432).
Ported: MetricsLogger (CSV and jsonl; no TensorBoard writer), the synthetic
loader, the prefetch iterator, the tiny smoke config and run_training on one
device. Not ported yet: the mesh / multi-host paths, validation, profiling,
load_from, resume and checkpoints (ROADMAP.md, M7 and M10).
"""
from __future__ import annotations

import csv
import json
import os
import queue
import threading
import time
from typing import Callable, Dict, Iterator, List

import numpy as np
import torch

from ..data.synthetic import PointCloudBatch, synthetic_kitti_batch
from ..train.hooks import NaNLadder, reinit_adversary_params
from ..train.loop import HostPlanBuilder, Trainer


class MetricsLogger:
    """Accumulates per-step scalars; writes the reference-compatible CSVs."""

    def __init__(self, work_dir: str):
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.l2_norms: List[float] = []
        self.l2_percentages: List[float] = []
        self.rows: List[Dict[str, float]] = []

    def log_step(self, logs: Dict) -> None:
        row = {k: float(v) for k, v in logs.items() if np.ndim(v) == 0}
        self.rows.append(row)
        if "perturbation_l2_norm" in row:
            self.l2_norms.append(row["perturbation_l2_norm"])
            self.l2_percentages.append(row.get("l2_percentage", 0.0))

    def save_l2_norms(self, filename: str = "l2_norms.csv") -> str:
        path = os.path.join(self.work_dir, filename)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["L2 Norm", "L2 Percentage", "Constraint Violations"])
            for n, pct in zip(self.l2_norms, self.l2_percentages):
                w.writerow([n, pct, 0.0])
        detailed = [r for r in self.rows if "perturbation_l2_norm" in r]
        if detailed:
            fields = ["l2_norm", "l2_percentage", "max_perturbation",
                      "mean_perturbation", "std_perturbation", "constraint_violation"]
            with open(path.replace(".csv", "_detailed.csv"), "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields)
                w.writeheader()
                for r in detailed:
                    w.writerow({"l2_norm": r.get("perturbation_l2_norm", 0.0),
                                "l2_percentage": r.get("l2_percentage", 0.0),
                                "max_perturbation": r.get("max_perturbation", 0.0),
                                "mean_perturbation": r.get("mean_perturbation", 0.0),
                                "std_perturbation": r.get("std_perturbation", 0.0),
                                "constraint_violation": 0.0})
        return path

    def save_history(self, filename: str = "train_log.jsonl") -> str:
        path = os.path.join(self.work_dir, filename)
        with open(path, "w") as f:
            for r in self.rows:
                f.write(json.dumps(r) + "\n")
        return path


def synthetic_loader(batch_size: int, steps_per_epoch: int, num_points: int = 20000,
                     seed: int = 0, point_range=(0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
                     ) -> Callable[[int], Iterator[PointCloudBatch]]:
    """Epoch -> iterator of synthetic numpy batches, seeded per epoch."""
    def epoch_iter(epoch: int):
        rng = np.random.RandomState(seed * 10007 + epoch)
        for _ in range(steps_per_epoch):
            yield synthetic_kitti_batch(rng, batch_size=batch_size, num_points=num_points,
                                        point_range=point_range)

    return epoch_iter


def prefetch_iterator(it: Iterator, depth: int = 2) -> Iterator:
    """Run `it` in a background thread behind a bounded queue, so the host
    work of producing the next item (the plan build) overlaps the step. A
    producer failure is re-raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(sentinel)
        except BaseException as e:  # noqa: BLE001 - transported to the consumer, re-raised there
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=60)


def with_plans(plan_builder: HostPlanBuilder, it: Iterator[PointCloudBatch]) -> Iterator:
    """(batch, host plan) per batch of `it`: the input pipeline that
    run_training puts behind prefetch_iterator. Each build's time is in
    `plan_builder.timings`."""
    for batch in it:
        yield batch, plan_builder(batch.points, batch.points_mask, batch.gt_boxes,
                                  batch.gt_labels, batch.gt_mask)


def tiny_voxelnet_cfg():
    """Shrunken-grid smoke config of the CLIs' --tiny flags: real SECOND
    channel widths on a 16 m grid."""
    from ..models.voxelnet import VoxelNetConfig
    from ..ops.voxelize import VoxelizerConfig

    return VoxelNetConfig(
        voxelizer=VoxelizerConfig(point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
                                  voxel_size=(0.5, 0.5, 0.125), max_points_per_voxel=3,
                                  max_voxels=512),
        anchor_ranges=tuple((0, -8.0, -0.6, 16.0, 8.0, -0.6) for _ in range(3)),
    )


def run_training(trainer: Trainer, epoch_loader: Callable[[int], Iterator[PointCloudBatch]],
                 work_dir: str, max_epochs: int, log_interval: int = 50, seed: int = 0,
                 start_epoch: int = 0) -> Dict:
    """The training loop on one device. The host plan (native index plan +
    anchor assignment) is built in the prefetch thread, overlapping the
    device step; `plan_build_ms` in the logs is the newest build's time,
    which must stay below the step time for the input pipeline to be free."""
    os.makedirs(work_dir, exist_ok=True)
    logger = MetricsLogger(work_dir)
    ladder = NaNLadder()
    plan_builder = trainer.make_plan_builder()

    if trainer.state is None:
        trainer.init_state(seed)
    reinit_gen = torch.Generator().manual_seed(seed)
    history: Dict = {}
    t_start = time.time()
    epoch = start_epoch
    for epoch in range(start_epoch, max_epochs):
        epoch_t0 = time.time()
        n_frames = 0
        batches = prefetch_iterator(with_plans(plan_builder, epoch_loader(epoch)))
        for i, (batch, plan) in enumerate(batches):
            logs = trainer.train_step(batch, epoch=epoch, plan=plan)
            n_frames += batch.points.shape[0]
            if (i + 1) % log_interval == 0 or i == 0:
                logs = {k: float(v) for k, v in logs.items()}
                logs["plan_build_ms"] = round(plan_builder.timings[-1]["plan_ms"], 1)
                logger.log_step(logs)
                if trainer.model.adversary is not None:
                    ladder.update(trainer.state, adversary_reinit_fn=lambda: reinit_adversary_params(
                        trainer.model.adversary, reinit_gen))
                print(f"[epoch {epoch} iter {i + 1}] "
                      + " ".join(f"{k}={v:.4f}" for k, v in sorted(logs.items())), flush=True)
                if ladder.should_stop:
                    print("[NaN ladder] too many consecutive NaNs - stopping", flush=True)
                    break
        dt = time.time() - epoch_t0
        print(f"[epoch {epoch}] done in {dt:.1f}s ({n_frames / max(dt, 1e-9):.2f} frames/s)",
              flush=True)
        if ladder.should_stop:
            break
    logger.save_l2_norms()
    logger.save_history()
    history["wall_time_s"] = time.time() - t_start
    history["final_epoch"] = epoch
    return {"state": trainer.state, "history": history, "work_dir": work_dir}
