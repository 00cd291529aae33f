"""Where a serving request's time goes on the card.

    python -m robustpointclouds_tpu_torch.tools.profile_serving [--seed N] [--requests N] [--top N]

Builds the full-width SECOND model (bf16, random weights from the seed) and
answers B=6 requests of synthetic 20000-point frames, clean and with
attack=True, as chip_smoke.py does. For each mode it prints:
  * the host plan build and the request's wall time (host clock around work
    that ends in a synchronise);
  * per stage, the device-timeline interval between CUDA events recorded
    around it (plan upload, adversary, VFE + gather, sparse encoder,
    backbone, neck, head, decode + NMS), averaged over the requests;
  * from torch.profiler over one request: the device busy time (sum of
    kernel times), its share of the wall time, and the top kernels by
    device time with their launch counts.
Needs a card; measures nothing on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core.spans import device_entries
from ..data.native_plan import build_plan_native
from ..data.synthetic import synthetic_kitti_batch
from ..models.detection import anchor_head_predict
from ..models.voxelnet import AdversarialVoxelNet, VoxelNetConfig, init_weights, plan_to_device

_STAGES = ("adversary", "middle_encoder", "backbone", "neck", "bbox_head")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA device")
    dev = torch.device("cuda")

    cfg = VoxelNetConfig()
    model = AdversarialVoxelNet(cfg)
    init_weights(model, torch.Generator().manual_seed(args.seed))
    model = model.to(dev).eval()
    anchors = torch.as_tensor(cfg.make_anchors()[0], device=dev)
    rng = np.random.RandomState(args.seed)

    events = {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[name] = ev

    for stage in _STAGES:
        mod = getattr(model, stage)
        mod.register_forward_pre_hook(lambda m, a, s=stage: mark(f"{s}<"))
        mod.register_forward_hook(lambda m, a, o, s=stage: mark(f"{s}>"))

    @torch.no_grad()
    def request(attack):
        b = synthetic_kitti_batch(rng, batch_size=6, num_points=20000, max_gt=20, num_objects=8,
                                  point_range=cfg.voxelizer.point_cloud_range)
        t0 = time.perf_counter()
        plan = build_plan_native(b.points, b.points_mask, cfg.voxelizer, 4)
        t1 = time.perf_counter()
        events.clear()
        mark("start")
        plan_t = plan_to_device(plan, dev)
        pts = torch.as_tensor(b.points, device=dev) if model.reads_points else None
        mark("uploaded")
        outs = model(pts, None, False, 100, attack, -1.0, plan_t)
        mark("model")
        anchor_head_predict(outs.cls_scores, outs.bbox_preds, outs.dir_preds, anchors, cfg.head)
        mark("end")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        stages = {"plan upload": events["start"].elapsed_time(events["uploaded"])}
        prev = "uploaded"
        for s in _STAGES:
            if f"{s}<" not in events:
                continue
            if s == "middle_encoder":  # the VFE, the voxel gather and the index conversions
                stages["vfe + gather"] = events[prev].elapsed_time(events[f"{s}<"])
            stages[s] = events[f"{s}<"].elapsed_time(events[f"{s}>"])
            prev = f"{s}>"
        stages["decode + nms"] = events["model"].elapsed_time(events["end"])
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3, stages

    for attack in (False, True):
        request(attack)  # warm-up: cuDNN plans, Triton compile, kernel build
        runs = [request(attack) for _ in range(args.requests)]
        mean = {k: float(np.mean([r[2][k] for r in runs])) for k in runs[0][2]}
        print(json.dumps({"attack": attack, "plan_ms": float(np.mean([r[0] for r in runs])),
                          "request_ms": float(np.mean([r[1] for r in runs])),
                          "stage_ms": mean}), flush=True)

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, wall_ms, _ = request(attack)
        kernels = device_entries(prof.key_averages())
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        print(json.dumps({"attack": attack, "profiled_request_ms": wall_ms,
                          "device_busy_ms": busy_ms,
                          "device_idle_share": 1.0 - busy_ms / wall_ms,
                          "kernel_launches": sum(e.count for e in kernels)}), flush=True)
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:args.top]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
