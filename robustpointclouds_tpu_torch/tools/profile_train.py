"""Where an adversarial train step's time goes on the card.

    python -m robustpointclouds_tpu_torch.tools.profile_train [--seed N] [--steps N] [--top N]

Builds the full-width SECOND trainer (bf16, random weights from the seed,
the reference TrainConfig) and runs B=6 train steps at epoch 3 (adversary
on) on synthetic 20000-point frames with GT boxes, as chip_smoke.py does.
It prints:
  * the host plan build and its two parts, the native plan and the anchor
    assignment (host clock, HostPlanBuilder.timings; in training it runs in
    the prefetch thread, here before each step) and the step's wall time (host clock around work that ends in a synchronise);
  * per stage, the device-timeline interval between CUDA events: plan
    upload, forward per module (adversary, VFE + gather, sparse encoder,
    backbone, neck, head), losses, backward per module (from the gradient
    reaching a module's output to it reaching the next module's output, in
    backward order; the adversary's interval ends where the optimizer
    starts), and the optimizer (sanitation, both Adam chains, BN restore,
    NaN ladder); means over the steps after one warm-up;
  * from torch.profiler over one step: the device busy time (sum of kernel
    times), its share of the wall time, and the top kernels by device time
    with their launch counts.
Needs a card; measures nothing on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..cli.common import synthetic_loader
from ..core.spans import device_entries
from ..models.voxelnet import VoxelNetConfig, plan_to_device
from ..train.loop import TrainConfig, Trainer

_STAGES = ("adversary", "middle_encoder", "backbone", "neck", "bbox_head")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    dev = torch.device("cuda")

    cfg = VoxelNetConfig()
    trainer = Trainer(cfg, TrainConfig(), device=dev)
    trainer.init_state(args.seed)
    builder = trainer.make_plan_builder()
    loader = synthetic_loader(6, args.steps + 2, num_points=20000, seed=args.seed,
                              point_range=cfg.voxelizer.point_cloud_range)
    batches = loader(0)

    events = {}

    def mark(name):
        if name not in events:  # first arrival only (a stage may have several outputs)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name] = ev

    def hook_outputs(out, stage):
        tensors = out if isinstance(out, (tuple, list)) else (out,)
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.requires_grad:
                t.register_hook(lambda g, s=stage: mark(f"{s} bwd"))

    def after_forward(stage):
        def hook(mod, args, out):  # returns None: the module's output stays as it is
            mark(f"{stage}>")
            hook_outputs(out, stage)
        return hook

    for stage in _STAGES:
        mod = getattr(trainer.model, stage)
        mod.register_forward_pre_hook(lambda m, a, s=stage: mark(f"{s}<"))
        mod.register_forward_hook(after_forward(stage))

    loss_fn, apply_fn = trainer._loss_fn, trainer._apply

    def loss_marked(*a, **k):
        out = loss_fn(*a, **k)
        mark("loss>")
        return out

    def apply_marked(*a, **k):
        mark("apply<")
        apply_fn(*a, **k)
        mark("apply>")

    trainer._loss_fn, trainer._apply = loss_marked, apply_marked

    def step():
        b = next(batches)
        plan = builder(b.points, b.points_mask, b.gt_boxes, b.gt_labels, b.gt_mask)
        t1 = time.perf_counter()
        events.clear()
        mark("start")
        plan_t = plan_to_device(plan, dev)
        mark("uploaded")
        logs = trainer.train_step(b, epoch=3, plan=plan_t)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        e = events
        stages = {"plan upload": e["start"].elapsed_time(e["uploaded"])}
        prev = "uploaded"
        for s in _STAGES:
            if s == "middle_encoder":
                stages["vfe + gather"] = e[prev].elapsed_time(e[f"{s}<"])
            stages[f"fwd {s}"] = e[f"{s}<"].elapsed_time(e[f"{s}>"])
            prev = f"{s}>"
        stages["losses"] = e["bbox_head>"].elapsed_time(e["loss>"])
        order = [s for s in reversed(_STAGES)]
        stages["bwd losses"] = e["loss>"].elapsed_time(e[f"{order[0]} bwd"])
        for s, nxt in zip(order, order[1:] + ["apply<"]):
            key = nxt if nxt == "apply<" else f"{nxt} bwd"
            stages[f"bwd {s}"] = e[f"{s} bwd"].elapsed_time(e[key])
        stages["optimizer"] = e["apply<"].elapsed_time(e["apply>"])
        return builder.timings[-1], (t2 - t1) * 1e3, stages, float(logs["loss"])

    step()  # warm-up: cuDNN plans, the kernels' build
    runs = [step() for _ in range(args.steps)]
    mean = {k: float(np.mean([r[2][k] for r in runs])) for k in runs[0][2]}
    print(json.dumps({**{k: float(np.mean([r[0][k] for r in runs]))
                         for k in ("plan_ms", "native_ms", "assign_ms")},
                      "step_ms": float(np.mean([r[1] for r in runs])),
                      "frames_per_s": 6e3 / float(np.mean([r[1] for r in runs])),
                      "loss": [r[3] for r in runs], "stage_ms": mean}), flush=True)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, wall_ms, _, _ = step()
    kernels = device_entries(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(json.dumps({"profiled_step_ms": wall_ms, "device_busy_ms": busy_ms,
                      "device_idle_share": 1.0 - busy_ms / wall_ms,
                      "kernel_launches": sum(e.count for e in kernels)}), flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
