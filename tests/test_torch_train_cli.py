"""The port's training entry point on the CPU: --synthetic --tiny --steps 2 --cpu
runs through run_training (plans built in the prefetch thread) and writes
the reference-schema l2_norms.csv; on tests/fixtures/kitti_mini it trains on
the KITTI loader and validates, resumes, freezes the detector, runs PGD
adversarial training from --cfg-options and writes a profiler trace and
TensorBoard events; --amp sets bfloat16 matmul precision while it trains
and restores it after; an undeclared flag raises "not ported yet" (--devices
refuses a batch the ranks do not divide); a zoo .pth --load-from
warm-starts the model."""
import csv
import glob
import json
import os

import pytest
import torch

import robustpointclouds_tpu_torch.kernels.sparse_conv as tsc
from robustpointclouds_tpu_torch.cli import train_kitti_3class_adversarial as cli
from robustpointclouds_tpu_torch.cli.common import prefetch_iterator
from robustpointclouds_tpu_torch.core.tensorboard import read_scalar_events
from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
from zoo_checkpoint import fake_zoo_state_dict, save_pth

KITTI_MINI = os.path.join(os.path.dirname(__file__), "fixtures", "kitti_mini")


def _kitti(work, *extra):
    return ["--data-root", KITTI_MINI, "--tiny", "--cpu", "--batch-size", "2", "--work-dir",
            str(work), *extra]


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


@pytest.mark.parametrize("argv", [["--synthetic", "--devices", "2"], ["--synthetic", "--amp"],
                                  ["--synthetic", "--load-from", "x.pth"], ["--unknown-flag"]])
def test_unported_flags_raise(argv, tmp_path, monkeypatch):
    if "--amp" in argv:
        # ported: the precision is set while run_training runs, restored after
        from robustpointclouds_tpu_torch.cli import common

        seen, real = [], common.run_training

        def recording(*a, **k):
            seen.append((torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32))
            return real(*a, **k)

        monkeypatch.setattr(common, "run_training", recording)
        before = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
        assert cli.parse_args(argv).amp
        out = cli.main([*argv, "--tiny", "--cpu", "--steps", "1", "--batch-size", "2",
                        "--work-dir", str(tmp_path / "wd")])
        assert seen == [("medium", True)] and out["state"].step == 1
        assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == before
        return
    if "--devices" in argv:
        # data parallel is ported: the flag parses, and JAX's refusal of a
        # batch the ranks do not divide comes before any rank starts
        assert cli.parse_args(argv).devices == 2
        with pytest.raises(SystemExit, match="--batch-size 3 not divisible by --devices 2"):
            cli.main([*argv, "--batch-size", "3", "--tiny", "--cpu", "--steps", "1",
                      "--work-dir", str(tmp_path / "wd")])
        return
    if "x.pth" in argv:
        # zoo .pth warm starts are ported: the flag parses, a missing file
        # raises where the warm start reads it
        assert cli.parse_args(argv).load_from == "x.pth"
        argv = [a if a != "x.pth" else str(tmp_path / a) for a in argv]
        with pytest.raises(FileNotFoundError):
            cli.main([*argv, "--tiny", "--cpu", "--steps", "1", "--work-dir",
                      str(tmp_path / "wd")])
        return
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.parse_args(argv)


def test_cli_warm_starts_from_a_zoo_pth(tmp_path, capsys):
    """--load-from a SECOND .pth (conv_input in spconv1's layout): 86
    tensors load before the first step; the adversary keeps its init."""
    from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg
    from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

    fresh = Trainer(tiny_voxelnet_cfg(), TrainConfig(), device="cpu")
    fresh.init_state(0)
    conv = "middle_encoder.conv_input.0.weight"
    zoo = fake_zoo_state_dict(fresh.model.state_dict(), seed=4, spconv1=[conv])
    pth = save_pth(zoo, str(tmp_path / "second.pth"))
    work = str(tmp_path / "wd")
    out = cli.main(["--synthetic", "--tiny", "--steps", "1", "--cpu", "--work-dir", work,
                    "--batch-size", "2", "--load-from", pth])
    assert f"[load-from] {pth} (second): loaded 86 tensors, skipped 0" in (
        capsys.readouterr().out)
    assert out["state"].step == 1
    saved = torch.load(os.path.join(work, "epoch_0.pt"), weights_only=True)["model"]
    want = torch.from_numpy(zoo[conv]).permute(4, 0, 1, 2, 3)
    assert torch.allclose(saved[conv], want, rtol=0, atol=1e-2)
    # the adversary, absent from the file, trained from the seed's init
    k = "adversary.mlp_out.weight"
    assert torch.allclose(saved[k], fresh.model.state_dict()[k], rtol=0, atol=1e-2)


def test_kitti_trains_two_steps_on_the_kitti_loader(tmp_path, capsys):
    work = tmp_path / "wd"
    out = cli.main(_kitti(work, "--steps", "2"))
    assert out["state"].step == 2 and out["start_epoch"] == 0
    printed = capsys.readouterr().out
    assert "falling back" not in printed and "[epoch 0 iter 2]" in printed
    assert CheckpointManager(str(work)).epochs() == [0]
    (events,) = glob.glob(str(work / "tf_logs" / "events.out.tfevents.*"))
    tags = [t for t, _, _ in read_scalar_events(events)]
    assert tags.count("train/loss") == 2 and "train/plan_build_ms" in tags


def test_kitti_validate_writes_the_best_checkpoint(tmp_path, capsys):
    work = tmp_path / "wd"
    out = cli.main(_kitti(work, "--steps", "1", "--validate", "--cfg-options", "val_interval=1"))
    val = out["history"]["val_epoch0"]
    assert val["num_frames"] == 1 and "mAP_3d_moderate" in val
    assert os.path.isfile(work / "best.pt")
    with open(work / "best_metric.json") as f:
        assert json.load(f) == {"value": val["mAP_3d_moderate"], "epoch": 0}
    assert "[val epoch 0]" in capsys.readouterr().out


def test_kitti_resume_continues_at_the_next_epoch(tmp_path, capsys):
    work = tmp_path / "wd"
    cli.main(_kitti(work, "--epochs", "2", "--steps-per-epoch", "1"))
    out = cli.main(_kitti(work, "--epochs", "3", "--steps-per-epoch", "1", "--resume"))
    assert out["start_epoch"] == 2 and out["state"].step == 3
    assert "[resume] restored epoch 1" in capsys.readouterr().out
    assert CheckpointManager(str(work)).epochs() == [1, 2]


def test_kitti_load_from_warm_starts_the_weights(tmp_path):
    first = tmp_path / "first"
    cli.main(_kitti(first, "--steps", "1", "--seed", "1"))
    out = cli.main(_kitti(tmp_path / "second", "--steps", "1", "--load-from", str(first)))
    assert out["state"].step == 1  # the optimizer state starts afresh


def test_kitti_freeze_detector_keeps_the_detector(tmp_path):
    from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg
    from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

    work = tmp_path / "wd"
    cli.main(_kitti(work, "--steps", "2", "--freeze-detector"))
    init = Trainer(tiny_voxelnet_cfg(), TrainConfig(), device="cpu")
    init.init_state(0)
    trained = Trainer(tiny_voxelnet_cfg(), TrainConfig(), device="cpu")
    trained.init_state(1)
    CheckpointManager(str(work)).restore(trained)
    before, after = init.model.state_dict(), trained.model.state_dict()
    names = [k for k, _ in trained.model.named_parameters()]
    for k in names:
        if not k.startswith("adversary."):
            assert torch.equal(after[k], before[k]), k
    assert any(not torch.equal(after[k], before[k]) for k in names if k.startswith("adversary."))


def test_kitti_pgd_adversarial_training_from_cfg_options(tmp_path, monkeypatch):
    calls = {"sparse_conv": 0, "sparse_conv_dgrad": 0, "sparse_conv_wgrad": 0}
    for name in calls:
        def counted(*a, _fn=getattr(tsc, name), _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(tsc, name, counted)
    out = cli.main(_kitti(tmp_path / "wd", "--steps", "2", "--cfg-options",
                          "pgd_adversary.steps=2"))
    assert out["state"].step == 2
    # per step: 2 attack steps (12 forwards + 12 input gradients each), then
    # the train step (the adversary runs, so conv_input's input needs a gradient)
    assert calls == {"sparse_conv": 2 * 12 * 3, "sparse_conv_dgrad": 2 * 12 * 3,
                     "sparse_conv_wgrad": 2 * 12}


def test_kitti_profile_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    cli.main(_kitti(tmp_path / "wd", "--steps", "11", "--profile", str(prof)))
    with open(prof / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert "[profile] wrote trace" in capsys.readouterr().out


def test_missing_kitti_falls_back_to_synthetic(tmp_path, capsys):
    out = cli.main(["--data-root", str(tmp_path / "none"), "--tiny", "--cpu", "--steps", "1",
                    "--batch-size", "2", "--work-dir", str(tmp_path / "wd")])
    assert out["state"].step == 1
    assert "KITTI not found" in capsys.readouterr().out


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
