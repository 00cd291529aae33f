"""Host-clock times of three host-bound paths of the port on the card, to compare two checkouts.

    python robustpointclouds_tpu_torch/tools/time_paths.py [--root DIR] [--reps N] [--seed N]

Imports robustpointclouds_tpu_torch from DIR (default: the current
directory, a checkout's root), so one copy of the script times another tree
too, such as a parent commit unpacked with `git archive`; the kernels build
in that tree. Run the trees in turns (A, B, B, A), one process each, on one card.

Full-width SECOND (VoxelNetConfig, bf16, random weights from the seed) on
B=6 synthetic 20000-point frames, each path after a warm-up:
  * serve: one clean self-contained request through export_serving, to its
    outputs on the host;
  * pgd10: run_evaluation of one batch under a 10-step PGD attack, the
    attack, forward and decode to the host (its `device_ms`: the plan
    build and the metric are left out);
  * pgd_at: one Trainer.train_step with TrainConfig(pgd_steps=2) at epoch 3
    on its host plan (built before the clock starts), to a synchronise.
Prints one JSON line: per path the ms of each rep, their median, and the
launches of K1's forward and of K2's apply kernel per call.
Needs a card; measures nothing on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".", help="checkout to import the port from")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_paths: needs a CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from robustpointclouds_tpu_torch.cli.common import run_evaluation, synthetic_loader
    from robustpointclouds_tpu_torch.cli.export import export_serving
    from robustpointclouds_tpu_torch.kernels.masked_stats import masked_batch_norm
    from robustpointclouds_tpu_torch.kernels.sparse_conv import sparse_conv
    from robustpointclouds_tpu_torch.models.voxelnet import VoxelNetConfig, plan_to_device
    from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

    import robustpointclouds_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise SystemExit(f"time_paths: imported {pkg.__file__}, not from {root}")
    dev = torch.device("cuda")
    cfg = VoxelNetConfig()
    trainer = Trainer(cfg, TrainConfig(pgd_steps=2), device=dev)
    trainer.init_state(args.seed)
    batches = list(synthetic_loader(6, args.reps + 1, num_points=20000, seed=args.seed,
                                    point_range=cfg.voxelizer.point_cloud_range)(0))
    builder = trainer.make_plan_builder()
    plans = [builder(b.points, b.points_mask, b.gt_boxes, b.gt_labels, b.gt_mask)
             for b in batches]
    serve = export_serving(trainer.model, None, cfg.make_anchors()[0], cfg.head)

    def run_serve(i):
        t0 = time.perf_counter()
        out = serve(batches[i].points, batches[i].points_mask)
        [t.cpu() for t in out]
        return (time.perf_counter() - t0) * 1e3

    def run_pgd10(i):
        timings = {}
        run_evaluation(trainer, [batches[i]], attack=True, attack_method="pgd", attack_steps=10,
                       timings=timings)
        return timings["batches"][0]["device_ms"]

    def run_pgd_at(i):
        plan_t = plan_to_device(plans[i], dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batches[i], epoch=3, plan=plan_t)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    result = {"root": root, "card": torch.cuda.get_device_name(0)}
    for name, fn in (("serve", run_serve), ("pgd10", run_pgd10), ("pgd_at", run_pgd_at)):
        fn(0)  # warm-up: the kernels' build and load, cuDNN plans
        torch.cuda.synchronize()
        k1, apply = sparse_conv.launches, masked_batch_norm.launches
        ms = [fn(1 + i) for i in range(args.reps)]
        result[name] = {"ms": ms, "median_ms": statistics.median(ms),
                        "k1_per_call": (sparse_conv.launches - k1) / args.reps,
                        "apply_per_call": (masked_batch_norm.launches - apply) / args.reps}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
