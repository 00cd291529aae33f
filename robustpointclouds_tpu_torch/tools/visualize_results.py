"""BEV visualisation of detections vs ground truth (counterpart of robustpointclouds_tpu/tools/visualize_results.py).

The reference's visResults.bat -> mmdet3d tools/misc/visualize_results.py
path: each frame's points, its GT boxes (green) and the detections (red,
with their scores) in bird's-eye view, as a PNG. The model is restored from
the newest port checkpoint of --work-dir (a random init when there is none,
as in JAX) and scores synthetic frames through the host plan, the eval
forward (the learned adversary's attack bounds with --attack) and
`anchor_head_predict`. The frames are synthetic whatever --synthetic and
--data-root say, as in JAX. Rendering is host work: matplotlib is imported
in `main` and must be installed. Runs on the card unless --cpu.

    python -m robustpointclouds_tpu_torch.tools.visualize_results \
        --work-dir work_dirs/kitti_3class_adversarial_torch --synthetic --out vis/
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np


def draw_bev(ax, points: np.ndarray, gt_boxes: np.ndarray, dt_boxes: np.ndarray,
             dt_scores: np.ndarray, point_range=(0, -40, 70.4, 40)):
    """Points as grey dots, GT boxes as green and detections as red BEV
    rectangles (x, y, dx, dy and yaw of each [7+] box), each detection's
    score beside its centre, on the (x0, y0, x1, y1) extent."""
    ax.scatter(points[:, 0], points[:, 1], s=0.2, c="#444444", linewidths=0)

    def corners(box):
        x, y, dx, dy, yaw = box[0], box[1], box[3], box[4], box[6]
        c, s = np.cos(yaw), np.sin(yaw)
        local = np.array([[dx, dy], [-dx, dy], [-dx, -dy], [dx, -dy]], np.float32) * 0.5
        world = local @ np.array([[c, s], [-s, c]], np.float32)
        return world + [x, y]

    for b in gt_boxes:
        cs = corners(b)
        ax.plot(*np.vstack([cs, cs[:1]]).T, color="limegreen", lw=1.2)
    for b, s in zip(dt_boxes, dt_scores):
        cs = corners(b)
        ax.plot(*np.vstack([cs, cs[:1]]).T, color="red", lw=1.0)
        ax.text(b[0], b[1], f"{s:.2f}", color="red", fontsize=6)
    ax.set_xlim(point_range[0], point_range[2])
    ax.set_ylim(point_range[1], point_range[3])
    ax.set_aspect("equal")


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Run the CLI; returns the written PNG paths."""
    p = argparse.ArgumentParser(description="Visualize detections in BEV")
    p.add_argument("--work-dir", default="work_dirs/kitti_3class_adversarial_torch")
    p.add_argument("--out", default="vis")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--data-root", default="data/kitti")
    p.add_argument("--attack", action="store_true", help="render under forced attack")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)

    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("visualize_results renders with matplotlib, which is not "
                           "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from ..cli.common import synthetic_loader, tiny_voxelnet_cfg
    from ..models.detection import anchor_head_predict
    from ..models.voxelnet import VoxelNetConfig
    from ..train.checkpoint import CheckpointManager
    from ..train.loop import TrainConfig, Trainer

    model_cfg, num_points = (tiny_voxelnet_cfg(), 512) if args.tiny else (VoxelNetConfig(), 20000)
    trainer = Trainer(model_cfg, TrainConfig(), device="cpu" if args.cpu else None)
    pcr = model_cfg.voxelizer.point_cloud_range
    batches = list(synthetic_loader(1, args.frames, num_points=num_points, seed=123,
                                    point_range=pcr)(0))
    trainer.init_state(0)
    ckpt = CheckpointManager(args.work_dir)
    if ckpt.latest_epoch() is not None:
        ckpt.restore(trainer)
        print(f"[vis] restored epoch {ckpt.latest_epoch()}", flush=True)

    plan_builder = trainer.make_plan_builder()
    mode = "attack" if args.attack else "clean"
    os.makedirs(args.out, exist_ok=True)
    paths = []
    for i, batch in enumerate(batches):
        outs = trainer.forward_eval(plan_builder(batch.points, batch.points_mask),
                                    attack=args.attack)
        with torch.no_grad():
            boxes, scores, _, mask = (t.cpu().numpy() for t in anchor_head_predict(
                outs.cls_scores, outs.bbox_preds, outs.dir_preds, trainer.anchors,
                model_cfg.head))
        fig, ax = plt.subplots(figsize=(10, 10))
        m, gm, pm = mask[0], np.asarray(batch.gt_mask[0]), np.asarray(batch.points_mask[0])
        draw_bev(ax, np.asarray(batch.points[0])[pm], np.asarray(batch.gt_boxes[0])[gm],
                 boxes[0][m], scores[0][m], point_range=(pcr[0], pcr[1], pcr[3], pcr[4]))
        ax.set_title(f"frame {i} ({mode}) — GT green, detections red")
        path = os.path.join(args.out, f"frame_{i:03d}_{mode}.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"[vis] wrote {path}", flush=True)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
