"""The inline plan's CUDA graph (core/graphs.py, models/voxelnet.sparse_plan_core).

On the CPU: CPU tensors take the eager body, counted, with the eager
function's plan key for key; the cache key separates shape, features and
voxelizer, and the cache keeps to its bound (a CPU stand-in for the
captured call); the route is eager while torch.compile / torch.export
traces, while the current stream is being captured and where autograd
records through the points; `fresh_copies` hands out equal tensors that
share no memory.

On the card (marked `cuda`, skipped elsewhere; this file imports torch and
numpy only, so it runs where JAX is not installed):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_plan_graph.py

the graphed SECOND plan equals the eager one bit for bit at full width on
the benchmark's seeded traffic, as does CenterPoint's at its own shapes;
a kept plan is unchanged by a later call; one capture and N - 1 replays
for N calls.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg
from robustpointclouds_tpu_torch.core import graphs
from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
from robustpointclouds_tpu_torch.models import voxelnet as tvn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = tiny_voxelnet_cfg().voxelizer


def flat(plan, prefix=""):
    """{path: tensor} of a nested plan."""
    if isinstance(plan, dict):
        return {k: v for n, sub in plan.items() for k, v in flat(sub, f"{prefix}/{n}").items()}
    if isinstance(plan, (list, tuple)):
        return {k: v for i, sub in enumerate(plan) for k, v in flat(sub, f"{prefix}/{i}").items()}
    return {prefix: plan}


def assert_plans_equal(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g.cpu(), w.cpu()), k


def tiny_points(seed, batch=2, points=400, features=4):
    b = synthetic_kitti_batch(np.random.RandomState(seed), batch_size=batch, num_points=points,
                              point_range=TINY.point_cloud_range)
    pts = torch.as_tensor(np.asarray(b.points))
    if features > pts.shape[-1]:
        pts = torch.cat([pts, torch.rand(*pts.shape[:2], features - pts.shape[-1])], -1)
    return pts, torch.as_tensor(np.asarray(b.points_mask))


class EagerEntry:
    """The CPU's stand-in for a captured call: the eager function on the
    call's inputs, with the key's first inputs kept as a capture keeps them."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, [x.clone() for x in inputs]

    def __call__(self, inputs):
        return self.fn(*inputs)


@pytest.fixture
def stand_in(monkeypatch):
    """PLAN_GRAPHS with the CPU stand-in, every call taken as replayable,
    and the counter read from zero; yields the cache."""
    cache = graphs.GraphCache(capacity=2, entry=EagerEntry)
    monkeypatch.setattr(tvn, "PLAN_GRAPHS", cache)
    monkeypatch.setattr(tvn, "PLAN_GRAPH_CALLS", cache.calls)
    monkeypatch.setattr(graphs, "replayable", lambda *t: True)
    return cache


def test_cpu_plan_runs_eager_and_counts_it():
    pts, mask = tiny_points(0)
    before = tvn.PLAN_GRAPH_CALLS["eager"]
    got = tvn.sparse_plan_core(pts, mask, TINY, 4)
    assert tvn.PLAN_GRAPH_CALLS["eager"] == before + 1
    assert_plans_equal(got, tvn.sparse_plan_eager(pts, mask, TINY, 4))


@pytest.mark.parametrize("change", ["batch", "points", "features", "voxelizer"])
def test_plan_graph_key_separates_signatures(change):
    pts, mask = tiny_points(1)
    base = tvn.plan_graph_key(pts, mask, TINY, 4)
    assert tvn.plan_graph_key(pts.clone(), mask.clone(), TINY, 4) == base
    assert tvn.plan_graph_key(pts.double(), mask, TINY, 4) == base  # no dtype in the key
    vz, f = TINY, 4
    if change == "batch":
        pts, mask = tiny_points(1, batch=3)
    elif change == "points":
        pts, mask = tiny_points(1, points=500)
    elif change == "features":
        pts, f = tiny_points(1, features=5)[0][..., :5], 5
    else:
        vz = TINY._replace(max_voxels=TINY.max_voxels * 2)
    assert tvn.plan_graph_key(pts, mask, vz, f) != base


def test_plan_cache_captures_once_a_signature_within_its_bound(stand_in):
    a, b, c = tiny_points(2), tiny_points(3, batch=3), tiny_points(4, points=500)
    for _ in range(3):
        got = tvn.sparse_plan_core(*a, TINY, 4)
    assert dict(stand_in.calls) == {"capture": 1, "replay": 2}
    assert_plans_equal(got, tvn.sparse_plan_eager(*a, TINY, 4))
    tvn.sparse_plan_core(*b, TINY, 4)
    tvn.sparse_plan_core(*a, TINY, 4)  # a is now the most recently used
    tvn.sparse_plan_core(*c, TINY, 4)  # over the bound: b goes
    assert len(stand_in.entries) == 2
    keys = [tvn.plan_graph_key(p[..., :4].float(), m, TINY, 4) for p, m in (a, b, c)]
    assert list(stand_in.entries) == [keys[0], keys[2]]
    tvn.sparse_plan_core(*b, TINY, 4)  # b is captured again
    assert dict(stand_in.calls) == {"capture": 4, "replay": 3}
    assert len(stand_in.entries) == 2
    # another feature count or voxelizer is another graph
    five = tiny_points(2, features=5)
    tvn.sparse_plan_core(*five, TINY, 5)
    tvn.sparse_plan_core(*a, TINY._replace(max_voxels=256), 4)
    assert stand_in.calls["capture"] == 6 and stand_in.calls["eager"] == 0


def card_like(requires_grad=False):
    """What `replayable` reads of a card tensor."""
    return types.SimpleNamespace(is_cuda=True, requires_grad=requires_grad)


@pytest.mark.parametrize("state", ["replay", "compiling", "capturing", "cpu", "grad"])
def test_replayable_chooses_eager_where_it_must(monkeypatch, state):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: state == "compiling")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state == "capturing")
    x = torch.zeros(2) if state == "cpu" else card_like(requires_grad=state == "grad")
    assert graphs.replayable(x, card_like()) == (state == "replay")
    if state == "grad":
        with torch.no_grad():
            assert graphs.replayable(x, card_like())


def test_compiling_routes_the_plan_eager(monkeypatch):
    """sparse_plan_core's own route: is_compiling set, replayable refuses
    even card-like inputs, and the eager body runs, counted."""
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    pts, mask = tiny_points(5)
    before = tvn.PLAN_GRAPH_CALLS["eager"]
    assert not graphs.replayable(card_like())
    assert_plans_equal(tvn.sparse_plan_core(pts, mask, TINY, 4),
                       tvn.sparse_plan_eager(pts, mask, TINY, 4))
    assert tvn.PLAN_GRAPH_CALLS["eager"] == before + 1


def test_fresh_copies_equal_and_share_no_memory():
    src = [torch.arange(6, dtype=torch.int32), torch.rand(2, 3), torch.tensor([True, False]),
           torch.arange(4, dtype=torch.int32).reshape(2, 2), torch.rand(5)]
    got = graphs.fresh_copies(src)
    for g, s in zip(got, src):
        assert g.dtype == s.dtype and torch.equal(g, s)
        assert g.untyped_storage().data_ptr() != s.untyped_storage().data_ptr()
    src[0].add_(1)
    assert torch.equal(got[0], torch.arange(6, dtype=torch.int32))


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def bench_batches(traffic: str, seed: int, n: int):
    """`n` batches of the benchmark's traffic file, from `seed`."""
    from benchmark import scenes

    with open(os.path.join(ROOT, "benchmark", "traffic", f"{traffic}.json")) as f:
        t = json.load(f)
    rng = np.random.default_rng(seed)
    return [scenes.frame_batch(rng, t) for _ in range(n)]


def on_card(batch, dev):
    return (torch.as_tensor(batch["points"], device=dev),
            torch.as_tensor(batch["points_mask"], device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", ["kitti-b6-train", "kitti-b6-attack-eval"])
def test_graphed_second_plan_equals_eager_at_full_width(cuda_device, traffic):
    vz = tvn.VoxelNetConfig().voxelizer
    for b in bench_batches(traffic, 2 ** 31 + 7, 3):
        pts, mask = on_card(b, cuda_device)
        got = tvn.build_plan(pts, mask, vz)
        assert_plans_equal(got, tvn.sparse_plan_eager(pts, mask, vz, 4))


@pytest.mark.cuda
def test_graphed_centerpoint_plan_equals_eager(cuda_device):
    from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
    from robustpointclouds_tpu_torch.models import centerpoint as tcp

    cfg = tcp.CenterPointConfig()
    rng = np.random.RandomState(3)
    for _ in range(2):
        b, _vel = synthetic_nuscenes_batch(rng, batch_size=4, num_points=30000,
                                           max_gt=cfg.head.max_objs,
                                           point_range=cfg.voxelizer.point_cloud_range)
        pts = torch.as_tensor(np.asarray(b.points), device=cuda_device)
        mask = torch.as_tensor(np.asarray(b.points_mask), device=cuda_device)
        before = dict(tvn.PLAN_GRAPH_CALLS)
        got = tcp.build_centerpoint_plan(pts, mask, cfg)
        assert tvn.PLAN_GRAPH_CALLS["eager"] == before.get("eager", 0)
        assert_plans_equal(got, tvn.sparse_plan_eager(pts, mask, cfg.voxelizer,
                                                      cfg.num_point_features))


@pytest.mark.cuda
def test_kept_plan_unchanged_by_the_next_call(cuda_device):
    vz = tvn.VoxelNetConfig().voxelizer
    b0, b1 = (on_card(b, cuda_device) for b in bench_batches("kitti-b6-train", 11, 2))
    first = tvn.build_plan(*b0, vz)
    kept = {k: v.clone() for k, v in flat(first).items()}
    second = tvn.build_plan(*b1, vz)
    torch.cuda.synchronize()
    ptrs = {v.data_ptr() for v in flat(second).values()}
    assert not ptrs & {v.data_ptr() for v in flat(first).values()}
    for k, v in flat(first).items():
        assert torch.equal(v, kept[k]), k
    assert not torch.equal(first["voxels"], second["voxels"])


@pytest.mark.cuda
def test_one_capture_then_replays(cuda_device, monkeypatch):
    cache = graphs.GraphCache(capacity=2)
    monkeypatch.setattr(tvn, "PLAN_GRAPHS", cache)
    monkeypatch.setattr(tvn, "PLAN_GRAPH_CALLS", cache.calls)
    vz = tvn.VoxelNetConfig().voxelizer
    batches = [on_card(b, cuda_device) for b in bench_batches("kitti-b6-attack-eval", 5, 4)]
    for pts, mask in batches:
        got = tvn.build_plan(pts, mask, vz)
    assert dict(cache.calls) == {"capture": 1, "replay": len(batches) - 1}
    assert_plans_equal(got, tvn.sparse_plan_eager(*batches[-1], vz, 4))
