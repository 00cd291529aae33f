"""The port's config files, builders and TensorBoard writer against the JAX package, on the CPU.

Checked, all exact (plain Python values, no arithmetic in another order):
  * Config.fromfile on every file under configs/ gives the same to_dict()
    as the JAX Config, and so do dotted --cfg-options overrides;
  * build_voxelnet_config and build_train_config give the same field values
    as the JAX builders, for the default config, the freeze-detector
    overrides of the training CLI and a `pgd_adversary` entry;
  * the TensorBoard writer: the CRC32C test vectors, and event files written
    by one package read back by the other's read_scalar_events.
"""
import dataclasses
import glob
import os

import pytest

from robustpointclouds_tpu.core import builders as jbuilders
from robustpointclouds_tpu.core import tensorboard as jtb
from robustpointclouds_tpu.core.config import Config as JConfig

from robustpointclouds_tpu_torch.core import builders as tbuilders
from robustpointclouds_tpu_torch.core import tensorboard as ttb
from robustpointclouds_tpu_torch.core.config import Config as TConfig
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.py"), recursive=True))
DEFAULT = os.path.join(REPO, "configs", "adversarial", "adversarial-second_kitti-3d-3class.py")

OVERRIDES = [
    ["model.adversary_cfg.sensor_error_bound=0.3", "max_epochs=7"],
    ["optim.lr=2e-4", "optim.adversary_lr_mult=5", "model.bbox_head.num_classes=3"],
    ["pgd_adversary.steps=2", "pgd_adversary.rel_step=1.5", "val_interval=1"],
    ["model.voxelizer.voxel_size=0.1,0.1,0.2", "model.test_cfg.score_thr=0.3",
     "model.adversary_cfg.use_spatial_attention=false", "load_from=none"],
]
FREEZE = dict(adversary_lr_mult=20.0, adversarial_loss_weight=0.5, regularization_weight=1e-5,
              freeze_detector=True, max_epochs=3, steps_per_epoch=6)


def test_every_config_file_is_found():
    assert len(CONFIGS) == 6 and DEFAULT in CONFIGS


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_fromfile_matches_jax(path):
    got, ref = TConfig.fromfile(path), JConfig.fromfile(path)
    assert got.to_dict() == ref.to_dict()
    assert sorted(got.keys()) == sorted(ref.keys())


@pytest.mark.parametrize("opts", OVERRIDES)
def test_cfg_options_match_jax(opts):
    got, ref = TConfig.fromfile(DEFAULT), JConfig.fromfile(DEFAULT)
    got.merge_from_cli(opts)
    ref.merge_from_cli(opts)
    assert got.to_dict() == ref.to_dict()
    with pytest.raises(ValueError, match="key=value"):
        got.merge_from_cli(["no_equals_sign"])


def _fields(nt) -> dict:
    """A config NamedTuple's fields, nested NamedTuples as plain tuples."""
    return {k: (tuple(v) if isinstance(v, tuple) else v) for k, v in nt._asdict().items()}


@pytest.mark.parametrize("opts", [[]] + OVERRIDES)
def test_build_voxelnet_config_matches_jax(opts):
    got_cfg, ref_cfg = TConfig.fromfile(DEFAULT), JConfig.fromfile(DEFAULT)
    got_cfg.merge_from_cli(opts)
    ref_cfg.merge_from_cli(opts)
    got = tbuilders.build_voxelnet_config(got_cfg)
    ref = jbuilders.build_voxelnet_config(ref_cfg)
    assert _fields(got) == _fields(ref)
    assert _fields(got.head) == _fields(ref.head)
    assert got.voxelizer.grid_size == ref.voxelizer.grid_size
    if not opts:  # the default config: the full SECOND widths with the adversary
        assert got.voxelizer.sparse_shape == (41, 1600, 1408)
        assert got.adversary == {"sensor_error_bound": 0.2, "use_spatial_attention": True,
                                 "hidden_channels": (64, 128, 64)}
        assert (got.adversarial_loss_weight, got.adversary_start_epoch) == (1.0, 3)


@pytest.mark.parametrize("overrides", [{}, FREEZE], ids=["default", "freeze"])
@pytest.mark.parametrize("opts", [[], ["pgd_adversary.steps=2"],
                                  ["pgd_adversary.steps=3", "pgd_adversary.rel_step=1.0"]])
def test_build_train_config_matches_jax(opts, overrides):
    got_cfg, ref_cfg = TConfig.fromfile(DEFAULT), JConfig.fromfile(DEFAULT)
    got_cfg.merge_from_cli(opts)
    ref_cfg.merge_from_cli(opts)
    got = dataclasses.asdict(tbuilders.build_train_config(got_cfg, **overrides))
    ref = dataclasses.asdict(jbuilders.build_train_config(ref_cfg, **overrides))
    assert got == ref
    assert got["pgd_steps"] == (int(opts[0].split("=")[1]) if opts else 0)
    assert got["freeze_detector"] == bool(overrides)


def test_crc32c_vectors():
    # RFC 3720: 32 bytes of zeros -> 0x8a9136aa; "123456789" -> 0xe3069283
    for data, crc in ((b"\x00" * 32, 0x8A9136AA), (b"123456789", 0xE3069283)):
        assert ttb._crc32c(data) == jtb._crc32c(data) == crc
        assert ttb._masked_crc(data) == jtb._masked_crc(data)


@pytest.mark.parametrize("writer,reader", [(ttb, jtb), (jtb, ttb)], ids=["port->jax", "jax->port"])
def test_tensorboard_round_trip(tmp_path, writer, reader):
    scalars = [("train/loss", 1.5, 0), ("train/loss", 0.75, 1), ("val/mAP", 42.0, 1),
               ("train/num_pos", 3.0, 300)]
    tb = writer.TensorBoardWriter(str(tmp_path))
    for tag, v, step in scalars:
        tb.add_scalar(tag, v, step, wall_time=1.0e9)
    tb.close()
    (path,) = glob.glob(os.path.join(str(tmp_path), "events.out.tfevents.*"))
    assert reader.read_scalar_events(path) == scalars
    assert writer.read_scalar_events(path) == scalars


def test_metrics_logger_writes_tf_logs(tmp_path):
    from robustpointclouds_tpu_torch.cli.common import MetricsLogger

    ml = MetricsLogger(str(tmp_path))
    ml.log_step({"loss": 2.0, "perturbation_l2_norm": 0.05, "l2_percentage": 1.2})
    ml.log_step({"loss": 1.0})
    ml.close()
    (path,) = glob.glob(os.path.join(str(tmp_path), "tf_logs", "events.*"))
    events = jtb.read_scalar_events(path)
    assert ("train/loss", 2.0, 0) in events and ("train/loss", 1.0, 1) in events
    assert any(t == "train/perturbation_l2_norm" for t, _, _ in events)
