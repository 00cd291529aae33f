"""Write an mmdet3d-format `kitti_dbinfos_train.pkl` and its GT-crop database (counterpart of robustpointclouds_tpu/tools/create_kitti_dbinfos.py).

The reference's db_sampler reads an offline dbinfos pickle, which mmdet3d
writes with `tools/create_data.py`. GT-paste also works without one
(on-the-fly collection, data/transforms.GroundTruthDatabase), but an offline
database fills the pool from the first batch on. This tool writes the same
layout and bytes as the JAX package's tool, the layout that
`GroundTruthDatabase.from_dbinfos` (and mmdet3d's DataBaseSampler) read:

    {class_name: [{"name", "path" (relative .bin of the crop, points stored
                   RELATIVE to the box bottom-center),
                   "box3d_lidar" (7-float, mmdet3d bottom-z convention),
                   "num_points_in_gt", "difficulty", "image_idx",
                   "gt_idx"}, ...]}

Usage:
    python -m robustpointclouds_tpu_torch.tools.create_kitti_dbinfos data/kitti \
        [--split train] [--out-dir data/kitti] [--min-points 1]
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List

import numpy as np


def create_dbinfos(data_root: str, split: str = "train",
                   out_dir: str = None, min_points: int = 1,
                   classes=("Car", "Pedestrian", "Cyclist")) -> Dict[str, List]:
    """Scan the raw KITTI layout and write crops + the dbinfos pickle.

    Returns the dbinfos dict. Crops land in `<out_dir>/kitti_gt_database/`,
    the pickle at `<out_dir>/kitti_dbinfos_<split>.pkl`; `path` entries are
    relative to out_dir so `from_dbinfos(pkl, data_root=out_dir)` loads them.
    """
    from ..data.kitti import KittiDataset
    from ..data.transforms import points_in_box

    out_dir = out_dir or data_root
    db_dir = os.path.join(out_dir, "kitti_gt_database")
    os.makedirs(db_dir, exist_ok=True)

    ds = KittiDataset(data_root, split=split, classes=classes)
    infos: Dict[str, List] = {c: [] for c in classes}
    for i in range(len(ds)):
        s = ds.get(i)
        fid = s["frame_id"]
        for j, (box, label, diff) in enumerate(
            zip(s["gt_boxes"], s["gt_labels"], s["gt_difficulty"])
        ):
            if label < 0:
                continue
            name = classes[label]
            crop = s["points"][points_in_box(s["points"], box)]
            if len(crop) < min_points:
                continue
            rel = crop.copy()
            # mmdet3d stores crop coords relative to the box BOTTOM center
            bottom = np.asarray(
                [box[0], box[1], box[2] - box[5] / 2.0], np.float32
            )
            rel[:, :3] -= bottom
            bin_name = f"{fid}_{name}_{j}.bin"
            rel.astype(np.float32).tofile(os.path.join(db_dir, bin_name))
            box_out = np.asarray(box, np.float32).copy()
            box_out[2] -= box_out[5] / 2.0  # center z -> mmdet3d bottom z
            infos[name].append({
                "name": name,
                "path": os.path.join("kitti_gt_database", bin_name),
                "image_idx": fid,
                "gt_idx": j,
                "box3d_lidar": box_out,
                "num_points_in_gt": int(len(crop)),
                "difficulty": int(diff),
            })
    pkl = os.path.join(out_dir, f"kitti_dbinfos_{split}.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(infos, f)
    counts = {c: len(v) for c, v in infos.items()}
    print(f"[dbinfos] {pkl}: {counts} "
          f"({sum(counts.values())} crops in {db_dir})")
    return infos


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Create kitti_dbinfos pickle + GT-crop database"
    )
    p.add_argument("data_root", help="raw KITTI root (training/velodyne ...)")
    p.add_argument("--split", default="train")
    p.add_argument("--out-dir", default=None,
                   help="where the database + pickle land (default data_root)")
    p.add_argument("--min-points", type=int, default=1)
    args = p.parse_args(argv)
    create_dbinfos(args.data_root, split=args.split, out_dir=args.out_dir,
                   min_points=args.min_points)


if __name__ == "__main__":
    main()
