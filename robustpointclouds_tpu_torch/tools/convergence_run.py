"""Convergence run: the full-width SECOND trained for thousands of inline steps on synthetic scenes (counterpart of robustpointclouds_tpu/tools/convergence_run.py).

    python -m robustpointclouds_tpu_torch.tools.convergence_run [steps] [--cpu] [--work-dir DIR]

The accuracy evidence that needs no dataset: the full-width
AdversarialVoxelNet (`VoxelNetConfig()`, bf16, B=6, 20000-point frames;
the adversary, its epoch-3 gate and the NaN ladder all active) trained on
CONV_SCENES structured synthetic batches (data/synthetic.py, ~60% of the
points on objects), with the KITTI AP of the repo's own metric before and
after, clean and under the learned attack (the reference's target: a 15-25%
drop, configs/adversarial/adversarial-second_hv_secfpn_8xb6-80e_kitti-3d-3class.py:70-76).

Training scenes are `synthetic_kitti_batch(RandomState(100 + i))` and live
on the device for the whole run; scene `i % CONV_SCENES` feeds step `i`.
Every step is the inline step, `Trainer.train_step(batch, epoch)` with no
plan: the voxels, the sparse index plan and the anchor assignment are built
on the device from the batch's points, so the loop builds no host plan.
The epoch ramps as real training would, `ci * scan_len / max(int(steps /
epochs), 1)` for chunk `ci`, so the adversary's epoch >= 3 gate opens
mid-run. A chunk of CONV_SCAN_LEN steps keeps its logs on the device and
reads them once at its end (one host sync a chunk).

CONV_FREEZE_STEPS > 0 adds the reference's --freeze-detector phase: a
second Trainer (detector learning off, adversary lr x20, adversarial weight
0.5, regularisation 1e-5) from phase 1's weights and BatchNorm buffers with
fresh Adam moments at epoch 999; afterwards phase 1's BatchNorm buffers are
restored, so the clean detector is exactly the trained one. As in the JAX
tool, `final_train_step` and `nan_total` in summary.json are read from the
state after the freeze phase when it runs; phase 1's NaN count is printed
on its own line. The evaluation scenes (`RandomState(900 + i)`, held out)
are scored clean before training and clean and under attack at the end,
through cli/common.run_evaluation (which builds their host plans).

Outputs under --work-dir (default work_dirs/torch_convergence/ from the
working directory: run from the repo root; never the JAX run's committed
work_dirs/convergence/, which it refuses):
    log.jsonl    -- per chunk: step, epoch, wall_s, the mean and `_last` of
                    every train log, nan_steps, train_step (the JAX run's keys)
    summary.json -- AP before / after, clean vs attack, wall / step stats
                    (the JAX run's keys and rounding)
    device.jsonl -- per chunk: its seconds, the peak and the end-of-chunk
                    allocated memory in GiB
    curves.png   -- loss, adversarial loss, l2 and num_pos (when matplotlib
                    imports)

Env: CONV_STEPS (2000), CONV_SCENES (10), CONV_EVAL_SCENES (4),
CONV_SCAN_LEN (50), CONV_EPOCHS (10), CONV_FREEZE_STEPS (0), CONV_TINY=1
(the 16 m smoke grid at B=2 of 512 points), BENCH_CPU=1 (as --cpu). Runs
on the card unless --cpu; raises without one.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..cli.common import run_evaluation
from ..data.synthetic import PointCloudBatch, synthetic_kitti_batch
from ..models.voxelnet import VoxelNetConfig
from ..ops.voxelize import VoxelizerConfig
from ..train.loop import TrainConfig, Trainer

DEFAULT_WORK_DIR = os.path.join("work_dirs", "torch_convergence")
JAX_RUN_DIR = os.path.join("work_dirs", "convergence")  # the JAX run's committed files
# the reference's --freeze-detector recipe (train_kitti_3class_adversarial)
FREEZE_TRAIN_CFG = TrainConfig(freeze_detector=True, adversary_lr_mult=20.0,
                               adversarial_loss_weight=0.5, regularization_weight=1e-5)
FREEZE_EPOCH = 999.0
_GIB = float(1 << 30)


def tiny_cfg() -> VoxelNetConfig:
    """The JAX tool's CONV_TINY config: the 16 m smoke grid, 256 voxels of 3 points."""
    return VoxelNetConfig(
        voxelizer=VoxelizerConfig(point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
                                  voxel_size=(0.5, 0.5, 0.125), max_points_per_voxel=3,
                                  max_voxels=256),
        anchor_ranges=((0, -8.0, -0.6, 16.0, 8.0, -0.6),) * 3)


def settings(argv_steps: Optional[int] = None) -> Dict:
    """The run's sizes from the environment (the JAX tool's names and defaults)."""
    env = os.environ.get
    tiny = env("CONV_TINY", "0") == "1"
    return {"steps": argv_steps if argv_steps is not None else int(env("CONV_STEPS", "2000")),
            "num_scenes": int(env("CONV_SCENES", "10")),
            "num_eval": int(env("CONV_EVAL_SCENES", "4")),
            "scan_len": int(env("CONV_SCAN_LEN", "50")),
            "epochs": float(env("CONV_EPOCHS", "10")),
            "freeze_steps": int(env("CONV_FREEZE_STEPS", "0")),
            "tiny": tiny,
            "batch_size": 2 if tiny else 6,
            "num_points": 512 if tiny else 20000}


def make_scenes(model_cfg, batch_size: int, num_points: int, seeds: Sequence[int]):
    """One synthetic batch per seed, numpy."""
    pr = model_cfg.voxelizer.point_cloud_range
    return [synthetic_kitti_batch(np.random.RandomState(s), batch_size=batch_size,
                                  num_points=num_points, max_gt=20, point_range=pr)
            for s in seeds]


def to_device(batch: PointCloudBatch, device) -> PointCloudBatch:
    """A batch's arrays as tensors on `device`, in the dtypes the step reads."""
    dtypes = (torch.float32, torch.bool, torch.float32, torch.int32, torch.bool)
    return PointCloudBatch(*(torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)
                             for x, dt in zip(batch, dtypes)))


def chunk_epoch(ci: int, scan_len: int, steps: int, epochs: float) -> float:
    """Chunk ci's epoch, float32 as the JAX tool passes it."""
    return float(np.float32(ci * scan_len / max(int(steps / epochs), 1)))


def run_chunk(trainer: Trainer, scenes: List[PointCloudBatch], epoch: float, first_step: int,
              n: int) -> Dict[str, np.ndarray]:
    """Steps first_step .. first_step + n - 1 on the inline path, scene
    `i % len(scenes)` for step i; the logs stay on the device until the one
    read at the end -> {key: [n] float64}."""
    logs = [trainer.train_step(scenes[i % len(scenes)], epoch)
            for i in range(first_step, first_step + n)]
    keys = sorted(logs[0])
    table = torch.stack([torch.stack([lg[k].float() for k in keys]) for lg in logs])
    table = table.cpu().numpy().astype(np.float64)  # the chunk's one sync
    return {k: table[:, j] for j, k in enumerate(keys)}


def chunk_record(step: int, epoch: float, wall_s: float, logs: Dict[str, np.ndarray],
                 train_step: int) -> Dict:
    """One log.jsonl record, with the JAX tool's keys and rounding."""
    rec = {"step": step, "epoch": round(epoch, 2), "wall_s": round(wall_s, 1)}
    for k in sorted(logs):
        rec[k] = round(float(np.mean(logs[k])), 5)
        rec[k + "_last"] = round(float(logs[k][-1]), 5)
    rec["nan_steps"] = int(np.sum(~np.isfinite(logs["loss"])))
    rec["train_step"] = int(train_step)
    return rec


def _memory(device) -> Dict[str, float]:
    if device.type != "cuda":
        return {}
    return {"peak_gib": torch.cuda.max_memory_allocated(device) / _GIB,
            "alloc_gib": torch.cuda.memory_allocated(device) / _GIB}


def train_phase(trainer: Trainer, scenes: List[PointCloudBatch], cfg: Dict, log_path: str,
                device_path: str) -> Dict:
    """Phase 1: steps // scan_len chunks of scan_len inline steps on the
    epoch ramp; one log.jsonl and device.jsonl record a chunk. Returns the
    wall seconds and the chunks' records."""
    steps, scan_len = cfg["steps"], cfg["scan_len"]
    n_chunks = max(steps // scan_len, 1)
    dev = trainer.device
    records, device_recs = [], []
    wall0 = time.time()
    with open(log_path, "w") as f, open(device_path, "w") as fd:
        for ci in range(n_chunks):
            epoch = chunk_epoch(ci, scan_len, steps, cfg["epochs"])
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.time()
            logs = run_chunk(trainer, scenes, epoch, ci * scan_len, scan_len)
            rec = chunk_record((ci + 1) * scan_len, epoch, time.time() - wall0, logs,
                               trainer.state.step)
            drec = {"step": rec["step"], "chunk_s": time.time() - t0, **_memory(dev)}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            fd.write(json.dumps(drec) + "\n")
            fd.flush()
            records.append(rec)
            device_recs.append(drec)
            mem = (f", peak {drec['peak_gib']:.3f} GiB, allocated {drec['alloc_gib']:.3f} GiB"
                   if "peak_gib" in drec else "")
            print(f"[chunk {ci}] step {rec['step']} epoch {rec['epoch']} loss {rec['loss']} "
                  f"nan_steps {rec['nan_steps']} {drec['chunk_s']:.2f} s{mem}", flush=True)
            if rec["nan_steps"]:
                st = trainer.state
                print(f"[nan] chunk {ci} epoch {rec['epoch']}: {rec['nan_steps']} NaN steps, "
                      f"lr_scale {float(st.lr_scale)}, adversary_enabled "
                      f"{float(st.adversary_enabled)}, nan_count {int(st.nan_count)}", flush=True)
    return {"wall_s": time.time() - wall0, "records": records, "device": device_recs}


def _bn_buffers(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def freeze_phase(trainer: Trainer, scenes: List[PointCloudBatch], cfg: Dict) -> Trainer:
    """The --freeze-detector phase from `trainer`'s weights and BN buffers,
    fresh Adam moments, epoch 999, max(freeze_steps // scan_len, 1) chunks;
    phase 1's BN buffers restored after. Returns the freeze trainer (the
    one that is evaluated, as in the JAX tool)."""
    phase1_bn = _bn_buffers(trainer.model)
    frz = Trainer(trainer.model_cfg, FREEZE_TRAIN_CFG, device=trainer.device)
    frz.init_state(state_dict=trainer.model.state_dict())
    scan_len = cfg["scan_len"]
    t0 = time.time()
    losses = None
    for ci in range(max(cfg["freeze_steps"] // scan_len, 1)):
        losses = run_chunk(frz, scenes, FREEZE_EPOCH, ci * scan_len, scan_len)["loss"]
    if not np.isfinite(losses).all():
        raise RuntimeError(f"freeze phase: non-finite losses in its last chunk: {losses}")
    print(f"freeze phase {cfg['freeze_steps']} steps {time.time() - t0:.0f}s", flush=True)
    with torch.no_grad():
        bufs = dict(frz.model.named_buffers())
        for k, v in phase1_bn.items():
            bufs[k].copy_(v)
    return frz


def summarize(cfg: Dict, wall: float, ap_before: Dict, ap_clean: Dict, ap_attack: Dict,
              trainer: Trainer) -> Dict:
    """summary.json, with the JAX tool's keys and rounding."""
    steps, batch_size = cfg["steps"], cfg["batch_size"]
    keys = [k for k in ap_clean if k.endswith("_3d_moderate") and not k.startswith("mAP")]
    mean_clean = float(np.mean([ap_clean[k] for k in keys])) if keys else 0.0
    mean_att = float(np.mean([ap_attack[k] for k in keys])) if keys else 0.0
    return {
        "steps": steps, "batch_size": batch_size, "scenes": cfg["num_scenes"],
        "wall_s": round(wall, 1),
        "step_ms": round(wall / steps * 1e3, 1),
        "frames_per_sec": round(steps * batch_size / wall, 2),
        "ap_before_3d_moderate": {k: round(ap_before.get(k, 0.0), 2) for k in keys},
        "ap_clean_3d_moderate": {k: round(ap_clean[k], 2) for k in keys},
        "ap_attack_3d_moderate": {k: round(ap_attack[k], 2) for k in keys},
        "mean_ap_clean": round(mean_clean, 2),
        "mean_ap_attack": round(mean_att, 2),
        "attack_drop_abs": round(mean_clean - mean_att, 2),
        "attack_drop_rel": round((mean_clean - mean_att) / max(mean_clean, 1e-9), 3),
        "final_train_step": int(trainer.state.step),
        "nan_total": int(trainer.state.nan_count),
    }


def plot_curves(log_path: str, out_path: str) -> None:
    """curves.png from log.jsonl; best-effort, as in the JAX tool."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        with open(log_path) as f:
            recs = [json.loads(line) for line in f]
        xs = [r["step"] for r in recs]
        fig, axes = plt.subplots(2, 2, figsize=(11, 7))
        axes[0, 0].plot(xs, [r["loss"] for r in recs])
        axes[0, 0].set_title("detection loss (chunk mean)")
        for k, ax in (("loss_adversarial", axes[0, 1]), ("l2_norm", axes[1, 0]),
                      ("num_pos", axes[1, 1])):
            if k in recs[0]:
                ax.plot(xs, [r[k] for r in recs])
                ax.set_title(k)
        for ax in axes.flat:
            ax.set_xlabel("step")
        fig.tight_layout()
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
    except Exception as exc:  # plotting is best-effort
        print(f"no curves.png: {exc}", flush=True)


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Convergence run of the full-width SECOND on "
                                            "synthetic scenes (PyTorch port)")
    p.add_argument("steps", nargs="?", type=int, default=None,
                   help="train steps (default CONV_STEPS, 2000)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--work-dir", default=DEFAULT_WORK_DIR, help="output directory")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the tool; returns the summary, phase 1's records, the evaluated
    trainer and the device scenes."""
    args = parse_args(argv)
    cpu = args.cpu or os.environ.get("BENCH_CPU", "0") == "1"
    out_dir = os.path.abspath(args.work_dir)
    if os.path.realpath(out_dir).endswith(os.sep + JAX_RUN_DIR):
        raise SystemExit(f"convergence_run: {out_dir} holds the JAX run's committed files")
    cfg = settings(args.steps)
    model_cfg = tiny_cfg() if cfg["tiny"] else VoxelNetConfig()
    trainer = Trainer(model_cfg, TrainConfig(), device="cpu" if cpu else None)
    trainer.init_state(0)
    os.makedirs(out_dir, exist_ok=True)

    bs, npts = cfg["batch_size"], cfg["num_points"]
    train_np = make_scenes(model_cfg, bs, npts, [100 + i for i in range(cfg["num_scenes"])])
    eval_np = make_scenes(model_cfg, bs, npts, [900 + i for i in range(cfg["num_eval"])])
    scenes = [to_device(b, trainer.device) for b in train_np]
    print(f"convergence: {cfg['steps']} steps x B={bs}, {cfg['num_scenes']} scenes, "
          f"device={trainer.device}"
          + (f" ({torch.cuda.get_device_name(trainer.device)})"
             if trainer.device.type == "cuda" else ""), flush=True)

    # AP before training: clean only (the attack on a random detector means nothing)
    t0 = time.time()
    ap_before = run_evaluation(trainer, eval_np, attack=False)
    print(f"eval(before) {time.time() - t0:.0f}s", flush=True)

    log_path = os.path.join(out_dir, "log.jsonl")
    phase1 = train_phase(trainer, scenes, cfg, log_path, os.path.join(out_dir, "device.jsonl"))
    print(f"phase 1: {trainer.state.step} steps, {int(trainer.state.nan_count)} NaN steps",
          flush=True)
    if cfg["freeze_steps"] > 0:
        trainer = freeze_phase(trainer, scenes, cfg)

    ap_clean = run_evaluation(trainer, eval_np, attack=False)
    ap_attack = run_evaluation(trainer, eval_np, attack=True)
    summary = summarize(cfg, phase1["wall_s"], ap_before, ap_clean, ap_attack, trainer)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    plot_curves(log_path, os.path.join(out_dir, "curves.png"))
    return {"summary": summary, "records": phase1["records"], "device": phase1["device"],
            "trainer": trainer, "scenes": scenes, "eval": eval_np, "cfg": cfg}


if __name__ == "__main__":
    main()
