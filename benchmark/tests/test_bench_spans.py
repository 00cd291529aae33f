"""The stage-span readings on a hand-made Chrome trace with known answers,
and every stage metric of BENCHMARK.json read by the harness off a traced
run of each cell at a test size on the CPU."""
import os
import time
import types

import pytest
import torch

from benchmark import harness, spans, trace

MAIN, AUTOGRAD = 1, 2  # host threads


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 100, "tid": tid,
            "ts": ts, "dur": dur}


def _runtime(name, ts, corr=None, tid=MAIN):
    e = {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 100, "tid": tid, "ts": ts,
         "dur": 2}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _device(ts, corr, cat="kernel", name="void at::native::vectorized_elementwise_kernel<4>"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": 10,
            "args": {"correlation": corr}}


TR = {"traceEvents": [
    _span(trace.WINDOW, 0, 1000),
    _span("rpc.train_step", 10, 890),
    _span("rpc.plan", 20, 80),
    _span("rpc.loss", 100, 100),
    _span("rpc.backward", 300, 300),
    _span("rpc.optimizer", 600, 200),
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 100, "tid": MAIN, "ts": 25,
     "dur": 10},
    _runtime("cudaLaunchKernel", 30, 1),                    # plan
    _runtime("cudaLaunchKernel", 150, 2),                   # loss
    _runtime("cudaMemcpyAsync", 250, 3),                    # the root's own
    _runtime("cudaLaunchKernel", 400, 4, tid=AUTOGRAD),     # backward, from another thread
    _runtime("cudaMemsetAsync", 650, 5),                    # optimizer
    _runtime("cudaLaunchKernel", 950, 6),                   # in no span
    _device(40, 1), _device(160, 2), _device(260, 3, cat="gpu_memcpy", name="Memcpy DtoD"),
    _device(410, 4), _device(660, 5, cat="gpu_memset", name="Memset"), _device(960, 6),
    _device(1500, 7),                                       # outside the window
    {"ph": "X", "cat": "gpu_user_annotation", "name": "rpc.train_step", "pid": 0, "tid": 8,
     "ts": 40, "dur": 630},
    _runtime("cudaEventSynchronize", 220),                  # the root's own
    _runtime("cudaDeviceSynchronize", 320),                 # backward
    _runtime("cudaStreamSynchronize", 700),                 # optimizer
    _runtime("cudaStreamSynchronize", 980),                 # after the root
    _runtime("cudaStreamQuery", 710),                       # not a sync
]}


def _ctx(tr=TR, kind="train", steps=1):
    span = trace.window(tr)
    return types.SimpleNamespace(kind=kind, trace=tr, span=span, steps=steps,
                                 events=trace.device_events(tr, span) if span else [])


def test_self_time_less_the_nested_spans():
    table = spans.stage_table(TR, trace.window(TR))
    assert table["train_step"]["self_us"] == 890 - (80 + 100 + 300 + 200)
    ctx = _ctx(steps=2)
    assert spans.stage_ms(ctx, "plan") == pytest.approx(0.04)
    assert spans.stage_ms(ctx, "backward") == pytest.approx(0.15)


def test_launch_from_another_thread_goes_to_the_span_it_lies_in():
    ctx = _ctx()
    assert spans.stage_ops(ctx, "backward") == 1
    assert [spans.stage_ops(ctx, s) for s in ("plan", "loss", "optimizer")] == [1, 1, 1]


def test_operation_launched_outside_every_span_goes_to_no_stage():
    table = spans.stage_table(TR, trace.window(TR))
    assert table[None]["ops"] == 1
    assert table["train_step"]["ops"] == 1  # the copy, the root's own


def test_annotations_are_not_operations():
    ctx = _ctx()
    table = spans.stage_table(TR, ctx.span)
    assert len(ctx.events) == 6
    assert sum(r["ops"] for r in table.values()) == len(ctx.events)


def test_stages_and_root_add_up_to_device_ops_per_step():
    inside = {"traceEvents": [e for e in TR["traceEvents"]
                              if e.get("args", {}).get("correlation") != 6]}
    ctx = _ctx(inside, steps=2)
    total = harness.metric_reader("device_ops_per_step.train").read(ctx)
    table = spans.stage_table(inside, ctx.span)
    stages = sum(spans.stage_ops(ctx, s) for s in spans.STAGES["train"] if s in table)
    assert stages + table["train_step"]["ops"] / ctx.steps == total == 2.5
    assert table[None]["ops"] == 0


def test_host_syncs_counts_the_three_sync_calls_inside_the_root():
    assert spans.host_syncs(_ctx()) == 3
    assert harness.metric_reader("host_syncs.train").read(_ctx(steps=3)) == 1.0


def test_no_spans_or_another_kind_read_nothing():
    bare = {"traceEvents": [e for e in TR["traceEvents"]
                            if not e["name"].startswith("rpc.")]}
    assert spans.stage_ms(_ctx(bare), "plan") is None
    assert spans.stage_ops(_ctx(bare), "plan") is None
    assert spans.host_syncs(_ctx(bare)) is None
    assert spans.stage_ms(_ctx(kind="eval"), "loss") is None  # eval has no loss stage
    assert spans.stage_ms(_ctx(kind="eval"), "plan") is None  # nor a train root
    assert spans.stage_ms(_ctx(), "decode") is None


def test_the_idle_of_a_stage():
    table = spans.stage_table(TR, trace.window(TR))
    assert table["plan"]["idle_us"] == 80 - 10
    assert table["plan"]["device_us"] == 10


TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
STAGE_METRICS = [m for m in harness.spec()["per_layer"]
                 if m["name"].split(".")[0] == "host_syncs"
                 or m["name"].split(".")[0].rsplit("_", 1)[0] in spans.STAGES["train"]
                 + spans.STAGES["eval"]]


@pytest.mark.parametrize("workload", ["second-kitti-3class.train-inline",
                                      "second-kitti-3class.attack-eval-inline"])
def test_every_stage_metric_reads_a_traced_cpu_run(workload):
    bench = dict(harness.load_json(TINY, "bench.json"), per_layer=STAGE_METRICS)
    out = harness.run(workload, 2**31 + 7, 1.0, True, time.perf_counter(),
                      device=torch.device("cpu"), bench=bench, base=TINY)
    want = sorted(m["name"] for m in STAGE_METRICS if workload in m["workloads"])
    assert len(want) == (15 if "train" in workload else 11)
    assert sorted(k for k in out["metrics"] if k in want) == want
    ms = [out["metrics"][k]["value"] for k in want if "_ms." in k]
    assert all(v > 0 for v in ms)
    # the CPU has no device operations and no card syncs
    assert all(out["metrics"][k]["value"] == 0 for k in want if "_ms." not in k)
