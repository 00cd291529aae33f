"""CenterPoint's stage spans and program counters on the CPU, and the
benchmark's readers of its two own spans on a synthetic Chrome trace.

Under torch.profiler one inline CenterPoint train step emits the train
step's spans (root, plan, adversary, encoder, dense, loss, backward,
optimizer) and its own two, `rpc.targets` under the root and `rpc.head`
inside `rpc.dense`, each once and in the order of the step; the serve emits
the serve's spans and `rpc.head`. The counters tick as the step and the
serve run: a heatmap splat a task and frame with its host reads, twelve
deformable adaptations a forward, one circle-NMS sweep a request.

On a hand-built trace the readers give the head's and the targets' wall
time and launches, a trace without the spans reads None, and the stage
table (benchmark/spans.py) still counts every device operation once: the
head's launches in `dense`, the targets' in the root's own.
"""
import os
import types

import pytest
import torch

from benchmark import harness, named_spans, scenes, spans as bench_spans, trace, weights
from benchmark.program import centerpoint as program
from benchmark.reference import centerpoint as reference
from robustpointclouds_tpu_torch.models import center_detection
from robustpointclouds_tpu_torch.nn import center_head
from robustpointclouds_tpu_torch.ops import nms
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "benchmark", "tests", "tiny")
CPU = torch.device("cpu")
EPOCH = 5.0
TRAIN_SPANS = ["train_step", "targets", "plan", "adversary", "encoder", "dense", "head", "loss",
               "backward", "optimizer"]
SERVE_SPANS = ["serve", "plan", "adversary", "encoder", "dense", "head", "decode"]


@pytest.fixture(scope="module")
def tiny():
    cfg = harness.load_config(os.path.join(TINY, "configs", "centerpoint-tiny.json"))
    cfg["model"]["compute_dtype"] = "float32"
    traffic = harness.load_json(TINY, "traffic", "nus-tiny-train.json")
    return cfg, harness.device_pool(scenes.pool(2**31 + 3, traffic), CPU)


def _spans(fn):
    """fn() under torch.profiler -> the stage spans as (name less "rpc.",
    start us, end us) in start order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    found = [(e.name[4:], e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith("rpc.")]
    return sorted(found, key=lambda x: (x[1], -x[2]))


def _counts():
    return (center_detection.TARGET_CALLS["splat"], center_detection.TARGET_CALLS["host_read"],
            center_head.DCN_CALLS["adapt"], nms.CIRCLE_NMS_CALLS["sweep"])


def test_train_step_spans_and_counters(tiny):
    cfg, pool = tiny
    t = program.trainer(cfg, CPU)
    t.init_state(0)
    before = _counts()
    found = _spans(lambda: program.train_step(t, program.batch(pool[0]), EPOCH))
    after = _counts()
    assert [n for n, _, _ in found] == TRAIN_SPANS
    root = found[0]
    assert all(root[1] <= s and e <= root[2] for _, s, e in found[1:])
    (_, ds, de), (_, hs, he) = found[5], found[6]
    assert ds <= hs and he <= de  # the head inside the dense body
    frames = pool[0]["points"].shape[0]
    splats = after[0] - before[0]
    assert splats == frames * 6
    assert splats <= after[1] - before[1] <= 2 * splats
    assert after[2] - before[2] == 12 and after[3] == before[3]


def test_serve_spans_and_counters(tiny):
    cfg, pool = tiny
    w = weights.make(reference.Reference(cfg, CPU).model, 5, CPU)
    serve, _ = program.server(cfg, CPU, w)
    b = pool[1]
    before = _counts()
    found = _spans(lambda: serve(b["points"], b["points_mask"], None, attack=True))
    after = _counts()
    assert [n for n, _, _ in found] == SERVE_SPANS
    assert after[0] == before[0] and after[2] - before[2] == 12
    assert after[3] - before[3] == 1  # every task keeps 64 candidates: one sweep


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _trace(with_new_spans=True):
    """A step of 1000 us: launches (correlation ids) in the targets, the
    plan, the dense body's own time, the head (two), the loss and the
    root's own time, each followed by its kernel."""
    ev = [_x(trace.WINDOW, "user_annotation", 0, 1000),
          _x("rpc.train_step", "user_annotation", 10, 890),
          _x("rpc.plan", "user_annotation", 100, 100),
          _x("rpc.dense", "user_annotation", 300, 200),
          _x("rpc.loss", "user_annotation", 500, 100)]
    if with_new_spans:
        ev += [_x("rpc.targets", "user_annotation", 20, 80),
               _x("rpc.head", "user_annotation", 350, 100)]
    for c, t in enumerate((30, 150, 320, 360, 400, 550, 700)):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", t, 2, correlation=c))
        ev.append(_x(f"kernel_{c}", "kernel", t + 5, 3, tid=7, correlation=c))
    return {"traceEvents": ev}


def _ctx(tr, kind="train"):
    span = trace.window(tr)
    return types.SimpleNamespace(kind=kind, span=span, trace=tr, steps=1,
                                 events=trace.device_events(tr, span))


def test_readers_of_the_head_and_targets_spans():
    ctx = _ctx(_trace())
    read = {m: harness.metric_reader(m).read(ctx)
            for m in ("head_ms.cp_train", "head_ops.cp_train", "targets_ms.cp_train",
                      "targets_ops.cp_train")}
    assert read == {"head_ms.cp_train": pytest.approx(0.1), "head_ops.cp_train": 2,
                    "targets_ms.cp_train": pytest.approx(0.08), "targets_ops.cp_train": 1}
    bare = _ctx(_trace(with_new_spans=False))
    assert named_spans.span_ms(bare, "rpc.head") is None
    assert named_spans.span_ops(bare, "rpc.targets") is None


@pytest.mark.parametrize("with_new_spans", [True, False])
def test_stage_table_counts_each_operation_once(with_new_spans):
    ctx = _ctx(_trace(with_new_spans))
    table = bench_spans.table(ctx)
    assert sum(r["ops"] for r in table.values()) == len(ctx.events) == 7
    assert table["dense"]["ops"] == 3 and table["train_step"]["ops"] == 2
    assert table[None]["ops"] == 0 and "head" not in table and "targets" not in table
    assert bench_spans.stage_ops(ctx, "dense") == 3
