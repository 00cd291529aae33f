"""Robustness-under-attack evaluation (counterpart of robustpointclouds_tpu/cli/evaluate_kitti_adversarial_attack.py).

    python -m robustpointclouds_tpu_torch.cli.evaluate_kitti_adversarial_attack \
        [--checkpoint DIR] [--work-dir DIR] [--method learned|pgd|fgsm] \
        [--pgd-steps 10] [--data-root data/kitti] [--batch-size 6] [--synthetic] \
        [--tiny] [--cpu] [--limit N] [--allow-random-init]

Scores the checkpoint clean, then under attack, and prints the mAP drop:
`learned` forces the learned adversary on with the evaluation-attack bounds
(the reference's measurement); `pgd` / `fgsm` are white-box gradient
attacks on the plan's voxels under the same physical envelope
(eval/attacks.py). Runs on the card unless --cpu.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="KITTI adversarial-attack evaluation (PyTorch port)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--work-dir", default="work_dirs/kitti_3class_adversarial_torch")
    p.add_argument("--data-root", default="data/kitti")
    p.add_argument("--batch-size", type=int, default=6)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--allow-random-init", action="store_true",
                   help="permit scoring an untrained model (smoke runs only)")
    p.add_argument("--method", default="learned", choices=("learned", "pgd", "fgsm"),
                   help="attack: the learned adversary (default) or the white-box gradient "
                        "baselines under the same physical envelope")
    p.add_argument("--pgd-steps", type=int, default=10)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, timings: Optional[Dict] = None):
    """Run the CLI; `timings`, when given, gets the evaluation timings
    (cli/common.run_evaluation) of the "clean" and "attacked" runs."""
    args = parse_args(argv)
    from .evaluate_kitti_3class import evaluate_checkpoint

    wd = args.checkpoint or args.work_dir
    common = dict(tiny=args.tiny, allow_random_init=args.allow_random_init,
                  device="cpu" if args.cpu else None)
    runs = {}
    for name, title, kw in (
            ("clean", "CLEAN EVALUATION (for comparison)", dict(attack=False)),
            ("attacked", "ATTACK EVALUATION (" + {
                "learned": "forced perturbations, eval bounds",
                "pgd": f"white-box PGD-{args.pgd_steps}, same physical envelope",
                "fgsm": "white-box FGSM, same physical envelope"}[args.method] + ")",
             dict(attack=True, attack_method=args.method, attack_steps=args.pgd_steps))):
        print("=" * 60 + f"\n{title}\n" + "=" * 60, flush=True)
        t = {} if timings is not None else None
        runs[name] = evaluate_checkpoint(wd, args.data_root, args.batch_size, args.synthetic,
                                         args.limit, timings=t, **common, **kw)
        if timings is not None:
            timings[name] = t
        print(json.dumps(runs[name], indent=2), flush=True)

    clean, attacked = runs["clean"], runs["attacked"]
    print("\n" + "=" * 60 + "\nATTACK EFFECTIVENESS")
    for key in sorted(clean):
        if key.endswith("_moderate") or key == "mAP_3d_moderate":
            c, a = clean.get(key, 0.0), attacked.get(key, 0.0)
            drop = c - a
            rel = 100.0 * drop / c if c > 0 else 0.0
            print(f"  {key}: clean={c:.2f} attacked={a:.2f} drop={drop:.2f} ({rel:.1f}%)",
                  flush=True)
    return {"clean": clean, "attacked": attacked}


if __name__ == "__main__":
    main()
