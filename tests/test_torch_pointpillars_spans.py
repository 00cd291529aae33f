"""PointPillars' stage spans and its plan counter on the CPU.

Under torch.profiler one inline PointPillars train step emits the train
step's spans (root, plan, adversary, encoder, dense, loss, backward,
optimizer), each once, in the order of the step and inside the root; the
serve emits the serve's (root, plan, adversary, encoder, dense, decode).
The pillar feature net, its row order and the BEV scatter run inside
`rpc.encoder`, with no sparse conv there. Each forward builds one pillar
plan, counted by models/voxelnet.PLAN_GRAPH_CALLS (the eager body on the
CPU; on the card a graph replay, tests/test_torch_plan_graph.py).
"""
import os

import pytest
import torch

from benchmark import harness, scenes, weights
from benchmark.program import pointpillars as program
from benchmark.reference import pointpillars as reference
from robustpointclouds_tpu_torch.models import voxelnet
from robustpointclouds_tpu_torch.ops import sparse
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "benchmark", "tests", "tiny")
CPU = torch.device("cpu")
EPOCH = 5.0
TRAIN_SPANS = ["train_step", "plan", "adversary", "encoder", "dense", "loss", "backward",
               "optimizer"]
SERVE_SPANS = ["serve", "plan", "adversary", "encoder", "dense", "decode"]


@pytest.fixture(scope="module")
def tiny():
    cfg = harness.load_config(os.path.join(TINY, "configs", "pointpillars-tiny.json"))
    cfg["model"]["compute_dtype"] = "float32"
    traffic = harness.load_json(TINY, "traffic", "kitti-tiny-train.json")
    return cfg, harness.device_pool(scenes.pool(2**31 + 3, traffic), CPU)


def _spans(fn):
    """fn() under torch.profiler -> the stage spans as (name less "rpc.",
    start us, end us) in start order, and the operators recorded."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    events = prof.events()
    found = [(e.name[4:], e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith("rpc.")]
    return sorted(found, key=lambda x: (x[1], -x[2])), events


def _inside(events, span):
    _, start, end = span
    return {e.name for e in events if start <= e.time_range.start and e.time_range.end <= end}


def test_train_step_spans_and_plan_count(tiny, monkeypatch):
    cfg, pool = tiny
    t = program.trainer(cfg, CPU)
    t.init_state(0)
    scatters = []
    real = sparse.scatter_to_dense
    monkeypatch.setattr("robustpointclouds_tpu_torch.models.pointpillars.scatter_to_dense",
                        lambda rows, grid: scatters.append(rows.shape) or real(rows, grid))
    before = voxelnet.PLAN_GRAPH_CALLS["eager"]
    found, events = _spans(lambda: program.train_step(t, program.batch(pool[0]), EPOCH))
    assert voxelnet.PLAN_GRAPH_CALLS["eager"] == before + 1
    assert [n for n, _, _ in found] == TRAIN_SPANS
    root = found[0]
    assert all(root[1] <= s and e <= root[2] for _, s, e in found[1:])
    for (_, _, e0), (_, s1, _) in zip(found[1:], found[2:]):
        assert e0 <= s1  # the stages follow each other, none nested in another
    assert len(scatters) == 1
    encoder = _inside(events, found[3])
    assert "aten::amax" in encoder and not any("sparse_conv" in n for n in encoder)
    assert not any(n.startswith("aten::conv") for n in encoder)
    assert any(n.startswith("aten::conv") for n in _inside(events, found[4]))


def test_serve_spans(tiny):
    cfg, pool = tiny
    w = weights.make(reference.Reference(cfg, CPU).model, 5, CPU)
    serve, _ = program.server(cfg, CPU, w)
    b = pool[1]
    before = voxelnet.PLAN_GRAPH_CALLS["eager"]
    found, _ = _spans(lambda: serve(b["points"], b["points_mask"], None, attack=True))
    assert [n for n, _, _ in found] == SERVE_SPANS
    assert voxelnet.PLAN_GRAPH_CALLS["eager"] == before + 1
