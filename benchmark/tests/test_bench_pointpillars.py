"""A whole run of the PointPillars train cell at a test size on the CPU
(tiny/bench_pointpillars.json), the look for a chip skipped: sound, it
comes out correct, and a traced run reads the cell's per-layer metrics that
a CPU trace holds; with the timed path broken underneath (each of
calibrate.FAULTS, and the state left unchanged), it comes out not correct;
the control (the reference one precision below the configuration's, in the
program's place) fails the limits; the architecture check refuses a model
of another width than the configuration file's; the new reference loads
nothing of the port or of JAX, and the family's program no JAX.

Readings on the CPU (seeds 2**31 + 101, + 7, + 8): sound `head_gap`
0.25-0.32, `grad_gap_median` 0.012-0.020, `change_gap_median` 0.008-0.015,
`change_gap` 0.16-0.19; the control's `head_gap` 2.1-2.5; half the batch a
head of another shape (1e9); the adversary's chain frozen `change_gap` 1.0;
the state unchanged 1.0 in all three leaf gaps."""
import os
import time

import pytest
import torch

from benchmark import calibrate, check, harness
from benchmark.program import pointpillars as program
from benchmark.tests.test_bench_imports import FORBIDDEN, PORT, _loaded
from robustpointclouds_tpu_torch.train import loop

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
BENCH = harness.load_json(TINY, "bench_pointpillars.json")
TRAIN = "pointpillars-kitti-3class.train-inline"
SEED = 2**31 + 101


def _run(traced=False, seconds=2.0):
    return harness.run(TRAIN, SEED, seconds, traced, time.perf_counter(),
                       device=torch.device("cpu"), bench=BENCH, base=TINY)


def test_sound_run_is_correct():
    out = _run(traced=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    # a CPU trace holds no device operation: only the host-clock readers read
    stages = ("plan", "adversary", "encoder", "dense", "loss", "backward", "optimizer")
    assert {f"{s}_ms.pp_train" for s in stages} | {"host_syncs.pp_train"} <= set(out["metrics"])
    assert "k2_roofline.pp_train" not in out["metrics"]


def _program_fault(name):
    """calibrate.FAULTS[name] laid over the harness's program of the family."""
    def apply(monkeypatch):
        make = harness.make_context

        def make_context(*a, **k):
            ctx = make(*a, **k)
            ctx.program = calibrate.FAULTS[name](ctx.program)
            return ctx
        monkeypatch.setattr(harness, "make_context", make_context)
    return apply


FAULTS = dict({f: _program_fault(f) for f in calibrate.FAULTS},
              state_unchanged=lambda mp: mp.setattr(loop.Trainer, "_apply", lambda self, *a: None))


@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(seconds=0.5)
    assert not out["correct"], out["checks"]


def test_control_fails_the_limits():
    wl = harness.workload(TRAIN, BENCH)
    cfg, traffic, limits = harness.cell_parts(wl, BENCH, TINY)
    ctx = harness.make_context(cfg, traffic, SEED, torch.device("cpu"))
    numbers, _ = calibrate.control_numbers(ctx, "train", float(traffic.get("epoch", 0)))
    assert not check.judge({k: numbers[k] for k in limits}, limits), numbers


@pytest.mark.parametrize("key,value", [("pfn_channels", 32), ("bev_shape", [16, 16]),
                                       ("pfn_in_features", 10)])
def test_architecture_check_refuses_another_width(key, value):
    cfg = harness.load_config(os.path.join(TINY, "configs", "pointpillars-tiny.json"))
    model = program.AdversarialPointPillars(program.model_config(cfg["model"]))
    program.check_architecture(model, cfg["model"])
    with pytest.raises(ValueError, match="not the configuration's"):
        program.check_architecture(model, dict(cfg["model"], **{key: value}))


def test_the_reference_loads_nothing_of_the_port_or_jax():
    loaded = _loaded(["benchmark.reference.pointpillars",
                      "benchmark.reference.plain.models.pointpillars"])
    assert not loaded & (FORBIDDEN | {PORT})


def test_the_harness_loads_the_port_and_no_jax():
    loaded = _loaded(["benchmark.harness", "benchmark.counts", "benchmark.program.pointpillars",
                      "benchmark.entries.train_inline"])
    assert PORT in loaded and not loaded & FORBIDDEN
