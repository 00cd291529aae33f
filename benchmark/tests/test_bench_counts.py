"""The op and byte counts against brute-force counts over the reference's own
plan at a test size: padding rows and slots never count."""
import json
import os

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, harness, scenes, weights
from benchmark.reference import second

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")


def _load(*p):
    with open(os.path.join(TINY, *p)) as f:
        return json.load(f)


def _setup(max_voxels=None):
    cfg = harness.load_config(os.path.join(TINY, "configs", "second-tiny.json"))
    if max_voxels:
        cfg["model"]["voxelizer"]["max_voxels"] = max_voxels
    ref = second.Reference(cfg, torch.device("cpu"))
    ref.model.load_state_dict(weights.make(ref.model, 3, torch.device("cpu")))
    ref.model.eval()
    t = dict(_load("traffic", "kitti-tiny-train.json"), pool=1, points_per_frame=300)
    b = {k: torch.as_tensor(v) for k, v in scenes.pool(9, t)[0].items()}
    return ref, b


def _records(ref, b):
    return counts.record(ref.model, lambda: ref.eval_heads(b))


def test_first_conv_hits_by_brute_force():
    ref, b = _setup()
    recs = [r for r in _records(ref, b) if r["kind"] == "sparse_conv"]
    assert len(recs) == 12
    plan = second.voxelnet.build_plan(b["points"], b["points_mask"], ref.net_cfg.voxelizer)
    coords = plan["grid_coords"][plan["grid_mask"]].tolist()
    active = {tuple(c) for c in coords}
    hits = sum((c[0], c[1] + dz, c[2] + dy, c[3] + dx) in active
               for c in coords for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    first = recs[0]
    assert (first["hits"], first["rows_out"], first["rows_in"]) == (hits, len(active), len(active))
    assert (first["cin"], first["cout"], first["taps"]) == (4, 16, 27)


def test_padding_never_counts():
    a = _records(*_setup(max_voxels=512))
    b = _records(*_setup(max_voxels=2048))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x["kind"] in ("sparse_conv", "masked_bn", "dense"):
            assert x == y
        elif x["kind"] == "perturber":
            assert x["rows"] == y["rows"] and x["slots"] < y["slots"]


def test_dense_flops_match_flop_counter():
    ref, b = _setup()
    recs = _records(ref, b)
    dense = 2 * sum(r["macs"] for r in recs if r["kind"] == "dense")
    m = ref.model
    n = ref.net_cfg.voxelizer.sparse_shape
    bev = torch.randn(2, m.middle_encoder.bev_channels, n[1] // 8, n[2] // 8)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        m.bbox_head(m.neck(m.backbone(bev)))
    assert dense == fc.get_total_flops()


def test_adversary_linears_count_valid_points_only():
    ref, b = _setup()
    recs = _records(ref, b)
    pert = next(r for r in recs if r["kind"] == "perturber")
    adv = ref.model.adversary
    macs = sum(m.in_features * m.out_features for m in adv.modules()
               if isinstance(m, torch.nn.Linear))
    assert pert["linear_macs"] == macs and pert["rows"] < pert["slots"]
    sparse = 2 * sum(r["hits"] * r["cin"] * r["cout"] for r in recs if r["kind"] == "sparse_conv")
    dense = 2 * sum(r["macs"] for r in recs if r["kind"] == "dense")
    assert np.isclose(counts.forward_flops(recs), sparse + dense + 2 * pert["rows"] * macs)
