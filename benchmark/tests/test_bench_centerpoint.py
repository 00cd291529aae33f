"""A whole run of each CenterPoint cell at a test size on the CPU
(tiny/bench_centerpoint.json), the look for a chip skipped: sound, it
comes out correct, and a traced run reads the cell's per-layer metrics;
with the timed path broken underneath (each of calibrate.FAULTS and the
state left unchanged in the train cell, half the batch or an altered
answer in the evaluation), it comes out not correct; the control (the
reference one precision below the configuration's, in the program's place)
fails the limits."""
import os
import time

import pytest
import torch

from benchmark import calibrate, harness
from robustpointclouds_tpu_torch.cli import export
from robustpointclouds_tpu_torch.models import center_detection
from robustpointclouds_tpu_torch.train import loop

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
BENCH = harness.load_json(TINY, "bench_centerpoint.json")
TRAIN = "centerpoint-nuscenes.train-inline"
EVAL = "centerpoint-nuscenes.attack-eval-inline"
SEED = 2**31 + 101


def _run(workload, traced=False, seconds=2.0):
    return harness.run(workload, SEED, seconds, traced, time.perf_counter(),
                       device=torch.device("cpu"), bench=BENCH, base=TINY)


@pytest.mark.parametrize("workload", [TRAIN, EVAL])
def test_sound_run_is_correct(workload):
    out = _run(workload, traced=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    # a CPU trace holds no device operation: only the host-clock readers read
    read = set(out["metrics"])
    assert {m for m in read if m.startswith(("head_ms", "targets_ms", "plan_ms"))} == (
        {"head_ms.cp_train", "targets_ms.cp_train", "plan_ms.cp_train"} if workload == TRAIN
        else {"head_ms.cp_eval", "plan_ms.cp_eval"})


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


def _halve_eval(monkeypatch):
    orig = export.ServingModule.forward

    def fwd(self, points, mask, plan=None, attack=False):
        return orig(self, calibrate.halve(points), calibrate.halve(mask), plan, attack)
    monkeypatch.setattr(export.ServingModule, "forward", fwd)


def _alter_answer(monkeypatch):
    orig = export.centerpoint_decode

    def decode(*a, **k):
        boxes, scores, labels, valid = orig(*a, **k)
        return boxes + 0.5, scores, labels, valid
    monkeypatch.setattr(export, "centerpoint_decode", decode)


def _one_radius(monkeypatch):
    """The decode with the scalar rule at the first task's radius."""
    orig = center_detection.centerpoint_decode
    monkeypatch.setattr(export, "centerpoint_decode",
                        lambda preds, cfg: orig(preds, cfg._replace(circle_radius=4.0)))


TRAIN_FAULTS = dict({f: _program_fault(f) for f in calibrate.FAULTS},
                    state_unchanged=lambda mp: mp.setattr(loop.Trainer, "_apply",
                                                          lambda self, *a: None))
EVAL_FAULTS = {"half_batch": _halve_eval, "answer_altered": _alter_answer,
               "one_radius": _one_radius}


@pytest.mark.parametrize("workload,fault", [(TRAIN, f) for f in TRAIN_FAULTS]
                         + [(EVAL, f) for f in EVAL_FAULTS])
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    (TRAIN_FAULTS if workload == TRAIN else EVAL_FAULTS)[fault](monkeypatch)
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", [TRAIN, EVAL])
def test_control_fails_the_limits(workload):
    from benchmark import check

    wl = harness.workload(workload, BENCH)
    cfg, traffic, limits = harness.cell_parts(wl, BENCH, TINY)
    ctx = harness.make_context(cfg, traffic, SEED, torch.device("cpu"))
    kind = "train" if workload == TRAIN else "eval"
    numbers, _ = calibrate.control_numbers(ctx, kind, float(traffic.get("epoch", 0)))
    assert not check.judge({k: numbers[k] for k in limits}, limits), numbers
