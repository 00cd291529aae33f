"""KITTI 3-class evaluation, clean (counterpart of robustpointclouds_tpu/cli/evaluate_kitti_3class.py).

    python -m robustpointclouds_tpu_torch.cli.evaluate_kitti_3class \
        [--mode clean|adversarial|both] [--checkpoint DIR] [--work-dir DIR] \
        [--load-from CKPT] [--allow-random-init] [--data-root data/kitti] \
        [--batch-size 6] [--synthetic] [--tiny] [--cpu] [--limit N] [--tta] \
        [--dump-results PKL]

'clean' scores a baseline checkpoint (default work dir
work_dirs/kitti_3class_baseline); 'adversarial' scores the adversarially
trained detector with perturbations off (--work-dir): the clean accuracy of
the robust model. --checkpoint points both at one directory of port
checkpoints (train/checkpoint.py). Attack-mode scores live in
evaluate_kitti_adversarial_attack. Without KITTI under --data-root (or with
--synthetic) it scores synthetic scenes: 4 batches, or as many as cover
--limit frames. Runs on the card unless --cpu.
"""
from __future__ import annotations

import argparse
import json
import traceback
from typing import Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="KITTI 3-class evaluation (PyTorch port)")
    p.add_argument("--mode", choices=("clean", "adversarial", "both"), default="both")
    p.add_argument("--checkpoint", default=None, help="explicit checkpoint dir")
    p.add_argument("--load-from", default=None,
                   help="port checkpoint (file or dir) or zoo .pth scored when the work dir "
                        "has no checkpoint")
    p.add_argument("--allow-random-init", action="store_true",
                   help="score an untrained model when no checkpoint exists (smoke runs only)")
    p.add_argument("--work-dir", default="work_dirs/kitti_3class_adversarial_torch")
    p.add_argument("--data-root", default="data/kitti")
    p.add_argument("--batch-size", type=int, default=6)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true", help="shrunken grid for smoke runs")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--limit", type=int, default=None, help="max val frames")
    p.add_argument("--tta", action="store_true", help="y-flip test-time augmentation")
    p.add_argument("--dump-results", default=None, metavar="PKL",
                   help="write per-frame detections (the reference's pklfile_prefix dump)")
    return p.parse_args(argv)


def evaluate_checkpoint(work_dir, data_root, batch_size, synthetic, limit, attack=False,
                        tiny=False, load_from=None, allow_random_init=False, dump_results=None,
                        tta=False, attack_method="learned", attack_steps=10, device=None,
                        timings: Optional[Dict] = None) -> Dict[str, float]:
    """Restore the latest checkpoint of `work_dir` (else `load_from`, else a
    random init when allowed) and score it (cli/common.run_evaluation)."""
    from ..data.kitti import kitti_available, kitti_val_loader
    from ..models.voxelnet import VoxelNetConfig
    from ..train.checkpoint import CheckpointManager, load_pretrained
    from ..train.loop import TrainConfig, Trainer
    from .common import run_evaluation, synthetic_loader, tiny_voxelnet_cfg

    model_cfg = tiny_voxelnet_cfg() if tiny else VoxelNetConfig()
    num_points = 512 if tiny else 20000
    trainer = Trainer(model_cfg, TrainConfig(), device=device)

    pcr = model_cfg.voxelizer.point_cloud_range
    if not synthetic and not kitti_available(data_root):
        print(f"[data] KITTI not found under {data_root!r}; using synthetic val", flush=True)
        synthetic = True
    if synthetic:
        n_batches = -(-limit // batch_size) if limit else 4
        batches = synthetic_loader(batch_size, n_batches, num_points=num_points, seed=999,
                                   point_range=pcr)(0)
    else:
        # KITTI frames keep the loader's 20000-point padding, --tiny too
        batches = kitti_val_loader(data_root, batch_size, model_cfg, limit=limit)

    trainer.init_state(0)
    ckpt = CheckpointManager(work_dir)
    latest = ckpt.latest_epoch()
    if latest is not None:
        try:
            ckpt.restore(trainer)
        except RuntimeError as e:
            raise RuntimeError(
                f"checkpoint in {work_dir!r} does not match the evaluated model (e.g. a --tiny "
                f"smoke run wrote it); point --checkpoint/--work-dir at the right run: {e}"
            ) from e
        print(f"[eval] restored epoch {latest} from {work_dir}", flush=True)
    elif load_from is not None:
        load_pretrained(trainer, load_from)
        print(f"[eval] no checkpoint in {work_dir}; warm start from {load_from}", flush=True)
    elif allow_random_init:
        print(f"[warn] no checkpoint in {work_dir}; evaluating RANDOM INIT "
              "(--allow-random-init)", flush=True)
    else:
        raise FileNotFoundError(
            f"no checkpoint in {work_dir!r} and no --load-from given; refusing to score a "
            "random init (pass --allow-random-init for smoke runs)")

    return run_evaluation(trainer, batches, attack=attack, dump_path=dump_results, tta=tta,
                          attack_method=attack_method, attack_steps=attack_steps,
                          timings=timings)


def main(argv: Optional[List[str]] = None, timings: Optional[Dict] = None):
    """Run the CLI; `timings`, when given, gets each mode's evaluation
    timings (cli/common.run_evaluation) under the mode's name."""
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    modes = {"clean": ("CLEAN BASELINE EVALUATION",
                       args.checkpoint or "work_dirs/kitti_3class_baseline"),
             "adversarial": ("ADVERSARIAL-MODEL EVALUATION (perturbations off)",
                             args.checkpoint or args.work_dir)}
    results = {}
    for mode, (title, wd) in modes.items():
        if args.mode not in (mode, "both"):
            continue
        print("=" * 60 + f"\n{title}\n" + "=" * 60, flush=True)
        t = {} if timings is not None else None
        try:
            results[mode] = evaluate_checkpoint(
                wd, args.data_root, args.batch_size, args.synthetic, args.limit,
                tiny=args.tiny, load_from=args.load_from,
                allow_random_init=args.allow_random_init, dump_results=args.dump_results,
                tta=args.tta, device=device, timings=t)
            print(json.dumps(results[mode], indent=2), flush=True)
        except Exception as e:  # noqa: BLE001 - the reference's per-mode SUCCESS/FAIL table
            traceback.print_exc()
            print(f"[{mode}] FAILED: {e}", flush=True)
            results[mode] = None
        if timings is not None:
            timings[mode] = t

    print("\n" + "=" * 60 + "\nSUMMARY")
    for mode, res in results.items():
        status = "SUCCESS" if res is not None else "FAILED"
        map_str = f" mAP_3d_moderate={res.get('mAP_3d_moderate', float('nan')):.2f}" if res else ""
        print(f"  {mode}: {status}{map_str}", flush=True)
    return results


if __name__ == "__main__":
    main()
