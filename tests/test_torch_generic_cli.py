"""The generic config-driven training entry point (cli/train.py) and the config builders.

  * core/builders: build_voxelnet_config, build_pointpillars_config,
    build_centerpoint_config, build_model_config and build_train_config on
    the repo's config files with --cfg-options overrides, field by field
    equal to the JAX package's builders (exact: they are parsed numbers);
  * `--cpu --synthetic` runs of cli/train.main on a tiny pillar config and a
    tiny SECOND config (shrunken grids of the repo's config files, as
    tests/test_train_cli.py does for the JAX CLI): a checkpoint per run,
    validation with best_metric.json, --auto-scale-lr's print;
  * CenterPoint dispatches to train_nuscenes_adversarial.run with the
    config, which builds its model and learning rate from it;
  * --amp sets bfloat16 matmul precision (torch's float32 matmul
    precision "medium", cuDNN's TF32 switch) while the CLI trains and
    restores both after;
    --devices refuses a batch_size the ranks do not divide and --multihost
    a job without a coordinator (tests/test_torch_multihost_cli.py runs
    both); a zoo .pth --load-from warm-starts the pillar model (a missing
    one raises FileNotFoundError).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from robustpointclouds_tpu.core import Config as JConfig
from robustpointclouds_tpu.core import builders as jb

from robustpointclouds_tpu_torch.cli import train as train_cli
from robustpointclouds_tpu_torch.cli import train_nuscenes_adversarial as nus_cli
from robustpointclouds_tpu_torch.core import builders as tb
from robustpointclouds_tpu_torch.core.config import Config
from robustpointclouds_tpu_torch.models.pointpillars import PointPillarsConfig
from robustpointclouds_tpu_torch.models.voxelnet import VoxelNetConfig
from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager
from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)
from zoo_checkpoint import fake_zoo_state_dict, save_pth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
PILLARS = os.path.join(CONFIGS, "adversarial", "adversarial-pointpillars_kitti-3d-3class.py")
SECOND = os.path.join(CONFIGS, "adversarial", "adversarial-second_kitti-3d-3class.py")
CENTERPOINT = os.path.join(CONFIGS, "adversarial", "adversarial-centerpoint_nuscenes.py")

# the pillar config on a 16 m grid of 0.5 m pillars (tests/test_pointpillars.py's tiny setup)
TINY_PILLARS = """
_base_ = ['{base}']
model = dict(
    voxelizer=dict(point_cloud_range=[0.0, -8.0, -3.0, 16.0, 8.0, 1.0],
                   voxel_size=[0.5, 0.5, 4.0], max_points_per_voxel=8, max_voxels=128),
    bbox_head=dict(anchor_ranges=[[0, -8.0, -1.78, 16.0, 8.0, -1.78],
                                  [0, -8.0, -0.6, 16.0, 8.0, -0.6],
                                  [0, -8.0, -0.6, 16.0, 8.0, -0.6]]),
    adversary_cfg=dict(hidden_channels=[8, 16, 8]),
)
max_epochs = 1
val_interval = 1
batch_size = 2
"""
# the SECOND config on the CLIs' --tiny grid (tests/test_train_cli.py's)
TINY_SECOND = """
_base_ = ['{base}']
model = dict(
    voxelizer=dict(point_cloud_range=[0.0, -8.0, -3.0, 16.0, 8.0, 1.0],
                   voxel_size=[0.5, 0.5, 0.125], max_points_per_voxel=3, max_voxels=512),
    bbox_head=dict(anchor_ranges=[[0, -8.0, -0.6, 16.0, 8.0, -0.6],
                                  [0, -8.0, -0.6, 16.0, 8.0, -0.6],
                                  [0, -8.0, -0.6, 16.0, 8.0, -0.6]]),
)
max_epochs = 1
val_interval = 1
batch_size = 2
auto_scale_lr = dict(base_batch_size=48)
"""


def _fields(x):
    """A NamedTuple or dataclass config as nested plain values."""
    if dataclasses.is_dataclass(x):
        return _fields(dataclasses.asdict(x))
    if hasattr(x, "_asdict"):
        return {k: _fields(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: _fields(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(_fields(v) for v in x)
    return x


def _assert_same(got, ref, path="cfg"):
    """Every field of the port's config equals the JAX config's field of
    that name (the JAX configs may carry more: variants not ported)."""
    if isinstance(got, dict):
        assert set(got) <= set(ref), (path, sorted(set(got) - set(ref)))
        for k in got:
            _assert_same(got[k], ref[k], f"{path}.{k}")
    else:
        assert got == ref, (path, got, ref)


@pytest.mark.parametrize("path, options", [
    (PILLARS, ["model.adversary_cfg.sensor_error_bound=0.3", "model.voxelizer.max_voxels=12000",
               "optim.lr=0.0002"]),
    (SECOND, ["model.adversary_cfg.sensor_error_bound=0.25", "model.adversary_start_epoch=1"]),
    (CENTERPOINT, ["model.adversary_cfg.sensor_error_bound=0.15", "optim.lr=0.0001"]),
], ids=["pointpillars", "second", "centerpoint"])
def test_builders_match_jax_on_the_config_files(path, options):
    cfgs = []
    for cls in (Config, JConfig):
        c = cls.fromfile(path)
        c.merge_from_cli(options)
        cfgs.append(c)
    got, ref = tb.build_model_config(cfgs[0]), jb.build_model_config(cfgs[1])
    assert type(got).__name__ == type(ref).__name__
    _assert_same(_fields(got), _fields(ref))
    assert got.adversary["sensor_error_bound"] == float(options[0].split("=")[1])
    specific = {PILLARS: (tb.build_pointpillars_config, jb.build_pointpillars_config),
                SECOND: (tb.build_voxelnet_config, jb.build_voxelnet_config),
                CENTERPOINT: (tb.build_centerpoint_config, jb.build_centerpoint_config)}[path]
    _assert_same(_fields(specific[0](cfgs[0])), _fields(specific[1](cfgs[1])))
    _assert_same(_fields(tb.build_train_config(cfgs[0])), _fields(jb.build_train_config(cfgs[1])))


def test_build_model_config_dispatch_and_unknown_type():
    cfg = Config.fromfile(PILLARS)
    assert isinstance(tb.build_model_config(cfg), PointPillarsConfig)
    assert tb.build_model_config(cfg).voxelizer.grid_size == (432, 496, 1)
    assert isinstance(tb.build_model_config(Config.fromfile(SECOND)), VoxelNetConfig)
    cfg.merge_from_cli(["model.type=NoSuchDetector"])
    with pytest.raises(ValueError, match="unknown model type"):
        tb.build_model_config(cfg)


def _write(tmp_path, text, base):
    path = tmp_path / "tiny.py"
    path.write_text(text.format(base=base))
    return str(path)


def test_cli_trains_pointpillars_on_the_cpu(tmp_path):
    cfg = _write(tmp_path, TINY_PILLARS, PILLARS)
    work = tmp_path / "wd"
    out = train_cli.main([cfg, "--synthetic", "--cpu", "--validate", "--steps-per-epoch", "2",
                          "--work-dir", str(work),
                          "--cfg-options", "model.adversary_cfg.sensor_error_bound=0.3"])
    assert out["work_dir"] == str(work)
    assert CheckpointManager(str(work)).latest_epoch() == 0
    assert "mAP_3d_moderate" in out["history"]["val_epoch0"]
    with open(work / "best_metric.json") as f:
        assert json.load(f)["epoch"] == 0
    assert os.path.isfile(work / "best.pt")
    assert len(out["plans"]) == 2 and out["plans"][0]["native_ms"] > 0


def test_cli_trains_second_on_the_cpu_with_auto_scale_lr(tmp_path, capsys):
    cfg = _write(tmp_path, TINY_SECOND, os.path.join(CONFIGS, "_base_", "kitti-3d-3class.py"))
    work = tmp_path / "wd"
    out = train_cli.main([cfg, "--synthetic", "--cpu", "--steps-per-epoch", "1",
                          "--work-dir", str(work), "--auto-scale-lr"])
    # batch 2 / base 48 of the base config's 1e-4
    assert "[auto-scale-lr] x0.042 -> lr 4.17e-06" in capsys.readouterr().out
    assert CheckpointManager(str(work)).latest_epoch() == 0
    assert out["history"]["final_epoch"] == 0 and len(out["epochs"]) == 1


def test_centerpoint_dispatches_with_its_config(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(nus_cli, "run", lambda **kw: seen.update(kw) or {"ok": True})
    assert train_cli.main([CENTERPOINT, "--cpu", "--synthetic", "--steps-per-epoch", "3",
                           "--work-dir", str(tmp_path),
                           "--cfg-options", "optim.lr=0.0003"]) == {"ok": True}
    assert seen["cfg"].get("optim")["lr"] == 0.0003
    assert (seen["device"], seen["batch_size"], seen["max_epochs"], seen["steps_per_epoch"],
            seen["synthetic"], seen["work_dir"]) == ("cpu", 1, 20, 3, True, str(tmp_path))


def test_nuscenes_run_builds_from_the_config(tmp_path, monkeypatch):
    import robustpointclouds_tpu_torch.cli.common as common

    captured = {}
    real = common.run_training

    def recording(trainer, *a, **kw):
        captured["trainer"] = trainer
        return real(trainer, *a, **kw)

    monkeypatch.setattr(common, "run_training", recording)
    cfg = Config.fromfile(CENTERPOINT)
    cfg.merge_from_cli(["optim.lr=0.0003", "model.adversarial_loss_weight=0.07"])
    out = nus_cli.run(cfg=cfg, work_dir=str(tmp_path), tiny=True, synthetic=True,
                      max_steps=1, device="cpu")
    tr = captured["trainer"]
    assert tr.train_cfg.learning_rate == 0.0003
    assert tr.model_cfg.adversarial_loss_weight == 0.07
    assert tr.model_cfg.adversary["hidden_channels"] == (16, 32, 64)
    assert CheckpointManager(str(tmp_path)).latest_epoch() is not None and out["state"] is not None


@pytest.mark.parametrize("flags", [["--devices", "4"], ["--multihost"], ["--amp"],
                                   ["--load-from", "zoo.pth"]],
                         ids=["devices", "multihost", "amp", "pth"])
def test_unported_flags_raise(flags, tmp_path, monkeypatch):
    if flags[0] == "--amp":
        # ported: the precision is set while run_training runs, restored after
        from robustpointclouds_tpu_torch.cli import common

        seen, real = [], common.run_training

        def recording(*a, **k):
            seen.append((torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32))
            return real(*a, **k)

        monkeypatch.setattr(common, "run_training", recording)
        before = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
        assert train_cli.parse_args([PILLARS, *flags]).amp
        out = train_cli.main([_write(tmp_path, TINY_PILLARS, PILLARS), "--cpu", "--synthetic",
                              "--steps-per-epoch", "1", "--work-dir", str(tmp_path / "wd"),
                              *flags])
        assert seen == [("medium", True)]
        assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == before
        assert CheckpointManager(out["work_dir"]).latest_epoch() == 0
        return
    if flags[0] == "--devices":
        # data parallel is ported: JAX's refusal of a batch the ranks do not divide
        with pytest.raises(SystemExit, match="batch_size 6 not divisible by --devices 4"):
            train_cli.main([PILLARS, "--cpu", "--synthetic", "--work-dir", str(tmp_path), *flags])
        return
    if flags[0] == "--multihost":
        # ported: a job with no coordinator anywhere is refused before any rendezvous
        for k in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(k, raising=False)
        with pytest.raises(ValueError, match="--multihost needs a coordinator"):
            train_cli.main([PILLARS, "--cpu", "--synthetic", "--work-dir", str(tmp_path), *flags])
        return
    if flags[0] == "--load-from":
        # zoo .pth warm starts are ported: a missing file raises where it is read
        flags = [flags[0], str(tmp_path / flags[1])]
        with pytest.raises(FileNotFoundError):
            train_cli.main([_write(tmp_path, TINY_PILLARS, PILLARS), "--cpu", "--synthetic",
                            "--work-dir", str(tmp_path), *flags])
        return
    with pytest.raises(SystemExit, match="not ported yet"):
        train_cli.main([PILLARS, "--cpu", "--synthetic", "--work-dir", str(tmp_path), *flags])


def test_cli_warm_starts_pointpillars_from_a_zoo_pth(tmp_path, capsys):
    """--load-from a PointPillars .pth: the PFN, the backbone stages' first
    convs, the neck and the head load before the first step (41 tensors)."""
    cfg = _write(tmp_path, TINY_PILLARS, PILLARS)
    model_cfg = tb.build_model_config(Config.fromfile(cfg))
    shapes = Trainer(model_cfg, TrainConfig(), device="cpu").model.state_dict()
    zoo = fake_zoo_state_dict(shapes, seed=3)
    pth = save_pth(zoo, str(tmp_path / "pointpillars.pth"))
    work = tmp_path / "wd"
    out = train_cli.main([cfg, "--synthetic", "--cpu", "--steps-per-epoch", "1",
                          "--work-dir", str(work), "--load-from", pth])
    assert f"[load-from] {pth} (pointpillars): loaded 41 tensors, skipped 0" in (
        capsys.readouterr().out)
    assert out["state"].step == 1
    # one optimizer step from the file's weights, not from the init's
    saved = torch.load(work / "epoch_0.pt", weights_only=True)["model"]
    for k in ("voxel_encoder.pfn_layers.0.linear.weight", "neck.deblocks.2.0.weight",
              "bbox_head.conv_cls.weight"):
        np.testing.assert_allclose(saved[k].numpy(), zoo[k], rtol=0, atol=1e-2, err_msg=k)
        assert not torch.equal(saved[k], torch.from_numpy(zoo[k])), k


def test_cli_runs_on_the_card_unless_cpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _write(tmp_path, TINY_PILLARS, PILLARS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([cfg, "--synthetic", "--steps-per-epoch", "1",
                        "--work-dir", str(tmp_path / "wd")])
