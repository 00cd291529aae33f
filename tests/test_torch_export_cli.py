"""The serving export's CLI (cli/export.main) and its two operators on the CPU.

  * torch.library.opcheck passes on rpc::sparse_conv_fwd (float32 and
    bfloat16) and rpc::masked_bn_apply (with a train-mode BN's batch
    statistics and with running statistics), with CPU inputs; the public
    wrappers reach them and count no launch on the CPU;
  * main: --tiny --cpu --allow-random-init writes the artifact and its meta
    (load_exported refuses it when the device it was exported for is not
    there); no checkpoint without --allow-random-init raises; a missing
    .pth --load-from raises FileNotFoundError; a port checkpoint restores
    through --work-dir, and a zoo .pth warm-starts through --load-from, into
    an artifact equal to the eager serve with those weights, and another
    model's checkpoint is refused.
The artifacts of the three families against the eager serve and against
JAX's: tests/test_torch_export.py; the card's side:
tests/test_torch_kernels_cuda.py.
"""
import json
import os

import numpy as np
import pytest
import torch

from robustpointclouds_tpu_torch.cli import export as texport
from robustpointclouds_tpu_torch.cli.common import tiny_pointpillars_cfg, tiny_voxelnet_cfg
from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
from robustpointclouds_tpu_torch.kernels.masked_stats import (
    masked_batch_norm, masked_bn_apply, masked_stats_ref)
from robustpointclouds_tpu_torch.kernels.sparse_conv import sparse_conv, sparse_conv_fwd
from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager, load_pretrained
from robustpointclouds_tpu_torch.train.loop import Trainer
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
from zoo_checkpoint import fake_zoo_state_dict, save_pth

KITTI_POINTS = 600


def _randomise_bn(model, rng):
    """Non-trivial eval-mode statistics and affine maps."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.randn(c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy((0.5 + rng.rand(c)).astype(np.float32)))
                m.weight.copy_(torch.from_numpy((0.5 + rng.rand(c)).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.randn(c).astype(np.float32)))


def _assert_equal(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_sparse_conv_fwd(dtype):
    rng = np.random.RandomState(4)
    feats = torch.from_numpy(rng.randn(40, 16).astype(np.float32)).to(dtype)
    kernel = torch.from_numpy(rng.randn(27 * 16, 32).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.randint(0, 41, (30, 27)).astype(np.int32))
    torch.library.opcheck(sparse_conv_fwd, (feats, kernel, idx))
    before = sparse_conv.launches
    assert torch.equal(sparse_conv(feats, kernel, idx), sparse_conv_fwd(feats, kernel, idx))
    assert sparse_conv.launches == before  # the CPU's plain version counts nothing


@pytest.mark.parametrize("train", [True, False])
def test_opcheck_masked_bn_apply(train):
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(50, 16).astype(np.float32))
    mask = torch.from_numpy(rng.rand(50) > 0.3)
    w = torch.from_numpy((0.5 + rng.rand(16)).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.randn(16).astype(np.float32))
    if train:  # the batch's statistics, as the train-mode BN normalises with
        mean, var, _ = masked_stats_ref(x, mask)
    else:  # running statistics
        mean = torch.from_numpy(0.1 * rng.randn(16).astype(np.float32))
        var = torch.from_numpy((0.5 + rng.rand(16)).astype(np.float32))
    for relu, row_mask, out_dtype in ((True, True, torch.bfloat16), (False, False, torch.float32)):
        args = (x, mask, mean, var, w, b, 1e-3, relu, row_mask, out_dtype)
        torch.library.opcheck(masked_bn_apply, args)
    before = masked_batch_norm.launches
    rm, rv = mean.clone(), var.clone()
    y = masked_batch_norm(x, mask, w, b, rm, rv, train, relu=True, row_mask=True)
    assert masked_batch_norm.launches == before
    if not train:
        assert torch.equal(y, masked_bn_apply(x, mask, mean, var, w, b, 1e-3, True, True,
                                              torch.float32))


def _main_args(out, *extra):
    return [str(out), "--tiny", "--cpu", "--batch-size", "1", "--num-points", str(KITTI_POINTS),
            *extra]


def test_main_refuses_random_weights_and_zoo_checkpoints(tmp_path):
    with pytest.raises(RuntimeError, match="refusing to export random weights"):
        texport.main(_main_args(tmp_path / "a.pt2"))
    with pytest.raises(RuntimeError, match="refusing"):  # an empty work dir restores nothing
        texport.main(_main_args(tmp_path / "a.pt2", "--work-dir", str(tmp_path / "none")))
    with pytest.raises(FileNotFoundError):  # a zoo .pth is read where it stands
        texport.main(_main_args(tmp_path / "a.pt2", "--load-from", str(tmp_path / "zoo.pth")))
    assert not (tmp_path / "a.pt2").exists()


def test_main_restores_work_dir_checkpoint(tmp_path):
    trainer = Trainer(tiny_voxelnet_cfg(), device="cpu")
    trainer.init_state(7)
    _randomise_bn(trainer.model, np.random.RandomState(7))
    work = tmp_path / "run"
    CheckpointManager(str(work)).save(0, trainer)
    out = tmp_path / "restored.pt2"
    texport.main(_main_args(out, "--work-dir", str(work)))
    call, meta = texport.load_exported(str(out))
    b = synthetic_kitti_batch(np.random.RandomState(9), batch_size=1, num_points=KITTI_POINTS,
                              max_gt=4, num_objects=3,
                              point_range=trainer.model_cfg.voxelizer.point_cloud_range)
    pts, msk = np.asarray(b.points), np.asarray(b.points_mask)
    head = trainer.model_cfg.head
    want = texport.export_serving(trainer.model, None, trainer.anchors, head,
                                  device="cpu")(pts, msk)
    _assert_equal(call(torch.from_numpy(pts), torch.from_numpy(msk)), want)
    # another model's checkpoint is refused with the reason
    other = tmp_path / "other"
    pp = Trainer(tiny_pointpillars_cfg(), device="cpu")
    pp.init_state(0)
    CheckpointManager(str(other)).save(0, pp)
    with pytest.raises(RuntimeError, match="does not match the exported model"):
        texport.main(_main_args(tmp_path / "x.pt2", "--work-dir", str(other)))


def test_main_bakes_a_zoo_warm_start(tmp_path, capsys):
    """--load-from a SECOND .pth: the artifact answers a request bit-equal
    to the eager serve of the same init warm-started from the same file."""
    trainer = Trainer(tiny_voxelnet_cfg(), device="cpu")
    trainer.init_state(0)
    pth = save_pth(fake_zoo_state_dict(trainer.model.state_dict(), seed=8),
                   str(tmp_path / "second.pth"))
    out = tmp_path / "zoo.pt2"
    texport.main(_main_args(out, "--load-from", pth))
    assert f"[load-from] {pth} (second): loaded 86 tensors, skipped 0" in (
        capsys.readouterr().out)
    load_pretrained(trainer, pth)
    call, _ = texport.load_exported(str(out))
    b = synthetic_kitti_batch(np.random.RandomState(9), batch_size=1, num_points=KITTI_POINTS,
                              max_gt=4, num_objects=3,
                              point_range=trainer.model_cfg.voxelizer.point_cloud_range)
    pts, msk = np.asarray(b.points), np.asarray(b.points_mask)
    want = texport.export_serving(trainer.model, None, trainer.anchors, trainer.model_cfg.head,
                                  device="cpu")(pts, msk)
    _assert_equal(call(torch.from_numpy(pts), torch.from_numpy(msk)), want)


def test_main_exports_random_init(tmp_path, monkeypatch):
    """--allow-random-init writes the artifact and its meta; load_exported
    refuses it when the device it was exported for is not here."""
    path = str(tmp_path / "tiny.pt2")
    meta = texport.main(_main_args(path, "--allow-random-init"))
    assert os.path.isfile(path) and os.path.isfile(path + ".json")
    with open(path + ".json") as f:
        assert json.load(f) == meta
    assert meta["platforms"] == ["cpu"] and meta["batch_size"] == 1
    assert meta["classes"] == ["Car", "Pedestrian", "Cyclist"]
    call, _ = texport.load_exported(path)
    boxes, scores, labels, valid = call(torch.zeros(1, KITTI_POINTS, 4),
                                        torch.zeros(1, KITTI_POINTS, dtype=torch.bool))
    assert boxes.shape[::2] == (1, 7) and not valid.any()  # no points, no detections
    with open(path + ".json", "w") as fh:  # as if exported on the card
        json.dump(dict(meta, platforms=["cuda"]), fh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="exported for cuda, and no cuda device is here"):
        texport.load_exported(path)
