"""A whole run of each cell at a test size on the CPU, the look for a chip
skipped: sound, it comes out correct; with the timed path broken underneath
(each fault the cell can have), it comes out not correct. And the control
(the reference one precision below the configuration's, in the program's
place) fails the limits."""
import os
import time

import pytest
import torch

from benchmark import calibrate, harness
from robustpointclouds_tpu_torch.cli import export
from robustpointclouds_tpu_torch.train import loop

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")
BENCH = harness.load_json(TINY, "bench.json")
TRAIN = ["second-kitti-3class.train-inline"]
EVAL = ["second-kitti-3class.attack-eval-inline"]
SEED = 2**31 + 101


def _run(workload, traced=False, seconds=2.0):
    return harness.run(workload, SEED, seconds, traced, time.perf_counter(),
                       device=torch.device("cpu"), bench=BENCH, base=TINY)


@pytest.mark.parametrize("workload", TRAIN + EVAL)
def test_sound_run_is_correct(workload):
    out = _run(workload, traced=workload in (TRAIN[0], EVAL[0]))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(out)[-1] == "checks"


def _halve_train(monkeypatch):
    orig = loop.Trainer.train_step

    def step(self, batch, epoch, plan=None):
        return orig(self, calibrate.halve(batch), epoch, plan)
    monkeypatch.setattr(loop.Trainer, "train_step", step)


def _freeze_adversary(monkeypatch):
    """The adversary's Adam chain advances its moments and moves nothing."""
    orig = loop.make_optimizers

    def make(cfg):
        det, adv = orig(cfg)
        calibrate.freeze_chain(adv)
        return det, adv
    monkeypatch.setattr(loop, "make_optimizers", make)


def _halve_eval(monkeypatch):
    orig = export.ServingModule.forward

    def fwd(self, points, mask, plan=None, attack=False):
        return orig(self, calibrate.halve(points), calibrate.halve(mask), plan, attack)
    monkeypatch.setattr(export.ServingModule, "forward", fwd)


def _alter_answer(monkeypatch):
    orig = export.anchor_head_predict

    def decode(*a, **k):
        boxes, scores, labels, valid = orig(*a, **k)
        return boxes + 0.5, scores, labels, valid | (scores > -2.0)
    monkeypatch.setattr(export, "anchor_head_predict", decode)


TRAIN_FAULTS = {
    "state_unchanged": lambda mp: mp.setattr(loop.Trainer, "_apply", lambda self, *a: None),
    "half_batch": _halve_train,
    "adversary_frozen": _freeze_adversary,
}
EVAL_FAULTS = {"half_batch": _halve_eval, "answer_altered": _alter_answer}


@pytest.mark.parametrize("workload,fault", [(w, f) for w in TRAIN for f in TRAIN_FAULTS]
                         + [(w, f) for w in EVAL for f in EVAL_FAULTS])
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    (TRAIN_FAULTS if workload in TRAIN else EVAL_FAULTS)[fault](monkeypatch)
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", TRAIN + EVAL)
def test_control_fails_the_limits(workload):
    from benchmark import check

    wl = harness.workload(workload, BENCH)
    cfg, traffic, limits = harness.cell_parts(wl, BENCH, TINY)
    ctx = harness.make_context(cfg, traffic, SEED, torch.device("cpu"))
    kind = "train" if workload in TRAIN else "eval"
    numbers, _ = calibrate.control_numbers(ctx, kind, float(traffic.get("epoch", 0)))
    assert not check.judge({k: numbers[k] for k in limits}, limits), numbers


@pytest.mark.cuda
def test_first_cell_correct_on_the_card():
    """The first cell at its own size on the card, a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = harness.run(TRAIN[0], SEED, 3.0, False, time.perf_counter())
    assert out["correct"], out["checks"]
