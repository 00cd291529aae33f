"""The port's training entry point on the CPU: --synthetic --tiny --steps 2 --cpu
runs through run_training (plans built in the prefetch thread) and writes
the reference-schema l2_norms.csv; flags that are not ported yet raise."""
import csv
import json
import os

import pytest
import torch

from robustpointclouds_tpu_torch.cli import train_kitti_3class_adversarial as cli
from robustpointclouds_tpu_torch.cli.common import prefetch_iterator


def test_cli_trains_two_steps_and_writes_l2_norms(tmp_path, capsys):
    work = str(tmp_path / "wd")
    out = cli.main(["--synthetic", "--tiny", "--steps", "2", "--cpu", "--work-dir", work,
                    "--batch-size", "2"])
    assert out["state"].step == 2 and out["state"].count == 2
    with open(os.path.join(work, "l2_norms.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["L2 Norm", "L2 Percentage", "Constraint Violations"]
    assert len(rows) == 3  # one row per logged step (--steps logs every step)
    with open(os.path.join(work, "train_log.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    assert len(logs) == 2
    for row in logs:
        assert all(k in row for k in ("loss", "loss_cls", "num_pos", "plan_build_ms"))
        assert row["plan_build_ms"] > 0
    assert "[epoch 0] done" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--synthetic", "--validate"], ["--synthetic", "--resume"],
                                  ["--synthetic", "--load-from", "x.pth"], ["--tiny"]])
def test_unported_flags_raise(argv):
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.parse_args(argv)


def test_prefetch_iterator_reraises_producer_errors():
    def producer():
        yield 1
        raise RuntimeError("plan build failed")

    it = prefetch_iterator(producer())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="plan build failed"):
        next(it)


def test_trainer_raises_without_a_card(monkeypatch):
    from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg
    from robustpointclouds_tpu_torch.train.loop import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tiny_voxelnet_cfg())


def test_nan_ladder_reinits_the_adversary_once_and_stops():
    from types import SimpleNamespace

    from robustpointclouds_tpu_torch.nn.perturber import VoxelPerturber
    from robustpointclouds_tpu_torch.train.hooks import NaNLadder, reinit_adversary_params

    adv = VoxelPerturber(hidden_channels=(8, 16, 8))
    gen = torch.Generator().manual_seed(0)
    calls = []

    def reinit():
        calls.append(1)
        reinit_adversary_params(adv, gen)

    ladder = NaNLadder()
    state = SimpleNamespace(nan_count=torch.tensor(9), consecutive_nan=torch.tensor(3))
    ladder.update(state, reinit)
    assert calls == []
    state.nan_count = torch.tensor(10)
    ladder.update(state, reinit)
    ladder.update(state, reinit)
    assert calls == [1] and not ladder.should_stop  # re-initialised exactly once
    for name, p in adv.named_parameters():
        if p.dim() >= 2:  # xavier-uniform x 0.001, as the JAX version draws them
            limit = 0.001 * (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
            assert 0 < p.abs().max().item() <= limit, name
        else:
            assert p.abs().max().item() == 0.0, name
    state.consecutive_nan = torch.tensor(50)
    ladder.update(state, reinit)
    assert ladder.should_stop
