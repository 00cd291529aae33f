"""The stage spans (core/spans.py) on the CPU at the tests' small SECOND config.

Under torch.profiler one inline train step and one serve emit each stage
span of their path exactly once, nested in their root in the order of the
step; with the profiler off no `record_function` is entered; the step's
logs, weights and the serve's detections are bit-identical with the
profiler on and off; torch.export of the serving module records no profiler
operation, with or without a profiler running; tools/parse_trace.stages
reads the spans' self time off a real trace.
"""
import json
import types

import numpy as np
import pytest
import torch

from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg
from robustpointclouds_tpu_torch.cli.export import export_program, export_serving
from robustpointclouds_tpu_torch.core import spans
from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
from robustpointclouds_tpu_torch.models.voxelnet import AdversarialVoxelNet
from robustpointclouds_tpu_torch.tools import parse_trace
from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

CPU = torch.device("cpu")
EPOCH = 5  # past the adversary's start epoch, as the benchmark's train cell
TRAIN_SPANS = ["train_step", "plan", "adversary", "encoder", "dense", "loss", "backward",
               "optimizer"]
SERVE_SPANS = {True: ["serve", "plan", "adversary", "encoder", "dense", "decode"],
               False: ["serve", "plan", "encoder", "dense", "decode"]}


def _batch(seed=0):
    return synthetic_kitti_batch(np.random.RandomState(seed), batch_size=2, num_points=512,
                                 max_gt=8, num_objects=3,
                                 point_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0))


def _trainer():
    t = Trainer(tiny_voxelnet_cfg(), TrainConfig(warmup_iters=5, max_epochs=2, steps_per_epoch=4),
                device=CPU)
    t.init_state(0)
    return t


def _server():
    """The serve of a fresh trainer's weights, every score kept (random
    weights score under the head's threshold)."""
    cfg = tiny_voxelnet_cfg()
    anchors, _ = cfg.make_anchors()
    return export_serving(AdversarialVoxelNet(cfg), _trainer().model.state_dict(), anchors,
                          cfg.head._replace(score_thr=0.0), device=CPU)


def _profiled(fn, path):
    """fn() under torch.profiler -> (its result, the trace's stage spans as
    [name less "rpc.", start, end] in start order, the trace)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        tr = json.load(f)
    found = sorted((e["ts"], -e["dur"], e["name"][4:], e["ts"] + e["dur"])
                   for e in tr["traceEvents"]
                   if e.get("cat") == "user_annotation" and e.get("name") in spans.STAGES)
    return out, [(name, s, e) for s, _, name, e in found], tr


def _nested_in_order(found):
    """The first span holds the others, which follow one another unnested."""
    (_, rs, re_), stages = found[0], found[1:]
    assert all(rs <= s and e <= re_ for _, s, e in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))


def test_span_is_a_shared_null_context_when_off_or_tracing(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert spans.span("rpc.plan") is spans.span("rpc.serve")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(spans.span("rpc.plan"), torch.profiler.record_function)
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        assert spans.span("rpc.plan") is spans.span("rpc.serve")


def test_device_entries_leave_out_the_spans():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ev = [types.SimpleNamespace(key=k, device_type=d) for k, d in (
        ("rpc.train_step", cuda), ("rpc.plan", cuda), ("void stats_kernel<float>", cuda),
        ("Memcpy HtoD", cuda), ("aten::add", cpu), ("rpc.plan", cpu))]
    assert [e.key for e in spans.device_entries(ev)] == ["void stats_kernel<float>",
                                                         "Memcpy HtoD"]


def test_train_step_spans(tmp_path):
    t, batch = _trainer(), _batch()
    _, found, tr = _profiled(lambda: t.train_step(batch, EPOCH, None), tmp_path / "t.json")
    assert [n for n, _, _ in found] == TRAIN_SPANS
    _nested_in_order(found)
    table = parse_trace.stages(tr, steps=1)
    assert [k for k in table if k is not None] == TRAIN_SPANS
    assert all(table[k]["spans"] == 1 for k in TRAIN_SPANS)
    own = (found[0][2] - found[0][1]) - sum(e - s for _, s, e in found[1:])
    assert table["train_step"]["self_ms"] == pytest.approx(own / 1e3)
    assert all(table[k]["self_ms"] == pytest.approx((e - s) / 1e3) for k, s, e in found[1:])
    assert table[None]["ops"] == 0  # a CPU trace holds no device operation


@pytest.mark.parametrize("attack", [True, False])
def test_serve_spans(tmp_path, attack):
    serve, b = _server(), _batch(1)
    _, found, _ = _profiled(lambda: serve(b.points, b.points_mask, None, attack=attack),
                            tmp_path / "s.json")
    assert [n for n, _, _ in found] == SERVE_SPANS[attack]
    _nested_in_order(found)


def test_profiler_off_enters_no_record_function(monkeypatch):
    t, serve, b = _trainer(), _server(), _batch()

    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    t.train_step(b, EPOCH, None)
    serve(b.points, b.points_mask, None, attack=True)
    # the patch is what a span would reach with the profiler on
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function entered"):
            serve(b.points, b.points_mask, None, attack=True)


def test_results_bit_identical_with_profiler_on_and_off():
    b = _batch()
    off, on = _trainer(), _trainer()
    logs_off = off.train_step(b, EPOCH, None)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        logs_on = on.train_step(b, EPOCH, None)
    assert logs_off.keys() == logs_on.keys()
    assert all(torch.equal(logs_off[k], logs_on[k]) for k in logs_off)
    p_on = dict(on.model.named_parameters())
    assert all(torch.equal(p, p_on[k]) for k, p in off.model.named_parameters())
    serve = _server()
    dets_off = serve(b.points, b.points_mask, None, attack=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        dets_on = serve(b.points, b.points_mask, None, attack=True)
    assert len(dets_off) == len(dets_on)
    assert all(torch.equal(x, y) for x, y in zip(dets_off, dets_on))
    assert int(dets_off[3].sum()) > 0  # detections to compare


def test_export_records_no_profiler_op():
    cfg = tiny_voxelnet_cfg()._replace(compute_dtype="float32")
    model = AdversarialVoxelNet(cfg)
    anchors, _ = cfg.make_anchors()

    def targets():
        ep, _ = export_program(model, anchors, cfg.head, 1, 512, device=CPU)
        return [str(n.target) for n in ep.graph.nodes]

    plain = targets()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = targets()
    assert profiled == plain
    assert not [t for t in plain if "profiler" in t]
