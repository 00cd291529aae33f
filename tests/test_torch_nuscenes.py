"""The port's NuScenes data path, metric and CLIs against the JAX package's, on the CPU.

On tests/fixtures/nuscenes_mini (the real mmdet3d layout: v2 info pickles,
5-float key frames and transformed sweeps):
  * the reader (multi-sweep, the native library and numpy) and both
    loaders give JAX's batches bit for bit from the same seed;
  * `synthetic_nuscenes_batch` and `eval_nuscenes_map` give JAX's arrays
    and dict exactly;
  * the eval CLI (--tiny) scores the same weights as JAX's `_evaluate`
    (tests/test_nuscenes_mini.py's run, its random init converted through
    tools/convert) to the same dict;
  * the train CLI takes two --tiny steps, writes a checkpoint and
    l2_norms.csv, and --resume goes on at the next epoch.
"""
import argparse
import os

import numpy as np
import pytest
import torch

import robustpointclouds_tpu.data.native as jax_native
from robustpointclouds_tpu.data import nuscenes as jnus
from robustpointclouds_tpu.eval.nuscenes_metric import eval_nuscenes_map as jax_eval_map

from robustpointclouds_tpu_torch.data import nuscenes as tnus
from robustpointclouds_tpu_torch.eval.nuscenes_metric import eval_nuscenes_map
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "nuscenes_mini")
TINY_PCR = (-12.8, -12.8, -5.0, 12.8, 12.8, 3.0)


class _Cfg:
    class voxelizer:  # only the range is read
        point_cloud_range = TINY_PCR


def _equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    if request.param == "numpy":  # the JAX reader takes numpy when no toolchain builds
        monkeypatch.setattr(jax_native, "native_available", lambda: False)
    return request.param


@pytest.mark.parametrize("split", ["train", "val"])
def test_reader_is_bit_equal_to_jax(path, split):
    ref = jnus.NuScenesDataset(FIXTURE, split=split)
    got = tnus.NuScenesDataset(FIXTURE, split=split, use_native=path == "native")
    assert len(got) == len(ref) >= 1
    for i in range(len(ref)):
        r, g = ref.get(i), got.get(i)
        assert sorted(r) == sorted(g)
        for k in r:
            _equal(g[k], r[k], f"{split}[{i}].{k}")
    s = got.get(0)
    lags = np.unique(s["points"][:, 4].round(3))
    assert 0.0 in lags and np.isclose(lags, 0.1).any()  # the key frame and a sweep


def test_native_and_numpy_sweeps_agree_within_rounding():
    """The two paths differ only in the transform's arithmetic (float32
    in C++, float64 in numpy), as in the JAX package."""
    a = tnus.NuScenesDataset(FIXTURE, "train").get(0)["points"]
    b = tnus.NuScenesDataset(FIXTURE, "train", use_native=False).get(0)["points"]
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("augment", [True, False], ids=["augment", "plain"])
def test_epoch_loader_is_bit_equal_to_jax(path, augment):
    kw = dict(batch_size=2, seed=3, steps_per_epoch=2, num_points=700, max_gt=16,
              max_sweeps=9, augment=augment)
    ref = jnus.nuscenes_epoch_loader(FIXTURE, model_cfg=_Cfg, **kw)
    got = tnus.nuscenes_epoch_loader(FIXTURE, model_cfg=_Cfg, use_native=path == "native", **kw)
    for epoch in (0, 1):
        n = 0
        for (rb, rv), (gb, gv) in zip(ref(epoch), got(epoch)):
            for f in rb._fields:
                _equal(getattr(gb, f), getattr(rb, f), f"epoch{epoch}.{f}")
            _equal(gv, rv, "vel")
            assert gb.points_mask.any() and gb.gt_mask.any()
            n += 1
        assert n == 2


def test_val_loader_is_bit_equal_to_jax(path):
    kw = dict(batch_size=2, num_points=900, max_gt=16, max_sweeps=9)
    ref = list(jnus.nuscenes_val_loader(FIXTURE, model_cfg=_Cfg, **kw))
    got = list(tnus.nuscenes_val_loader(FIXTURE, model_cfg=_Cfg, use_native=path == "native",
                                        **kw))
    assert len(got) == len(ref) >= 1
    for (rb, rv, rm), (gb, gv, gm) in zip(ref, got):
        for f in rb._fields:
            _equal(getattr(gb, f), getattr(rb, f), f)
        _equal(gv, rv, "vel")
        assert [m["valid"] for m in gm] == [m["valid"] for m in rm]
        for a, b in zip(gm, rm):
            _equal(a["gt_attrs"], b["gt_attrs"], "gt_attrs")


def test_synthetic_batch_is_bit_equal_to_jax():
    rb, rv = jnus.synthetic_nuscenes_batch(np.random.RandomState(5), batch_size=3,
                                           num_points=3000, max_gt=20, num_objects=7)
    gb, gv = tnus.synthetic_nuscenes_batch(np.random.RandomState(5), batch_size=3,
                                           num_points=3000, max_gt=20, num_objects=7)
    for f in rb._fields:
        _equal(getattr(gb, f), getattr(rb, f), f)
    _equal(gv, rv, "vel")


def test_metric_dict_equals_jax():
    rng = np.random.RandomState(6)
    gts, dts = [], []
    for _ in range(5):
        n, m = rng.randint(3, 12), rng.randint(5, 30)
        gb = np.concatenate([rng.uniform(-30, 30, (n, 2)), rng.uniform(-2, 0, (n, 1)),
                             rng.uniform(0.5, 5, (n, 3)), rng.uniform(-3, 3, (n, 1))], 1)
        gl = rng.randint(0, 10, n)
        # detections: jittered copies of the GTs plus clutter, with velocities
        pick = rng.randint(0, n, m)
        db = gb[pick] + rng.normal(0, 0.6, gb[pick].shape)
        db = np.concatenate([db, rng.normal(0, 2, (m, 2))], 1)
        dl = np.where(rng.rand(m) < 0.8, gl[pick], rng.randint(0, 10, m))
        gts.append({"boxes_3d": gb.astype(np.float32), "labels": gl,
                    "vel": rng.normal(0, 2, (n, 2)).astype(np.float32),
                    "attrs": rng.randint(0, 9, n).astype(np.int32)})
        dts.append({"boxes_3d": db.astype(np.float32), "labels": dl,
                    "score": rng.rand(m).astype(np.float32)})
    ref = jax_eval_map(gts, dts, tnus.NUSCENES_CLASSES)
    got = eval_nuscenes_map(gts, dts, tnus.NUSCENES_CLASSES)
    assert got == ref
    assert ref["mAP"] > 0 and ref["NDS"] > 0


def test_eval_cli_on_the_fixture_scores_like_jax(tmp_path, monkeypatch):
    """JAX's _evaluate on its random init (taken from its own init_state
    call) and the port's CLI on that init, converted: the same dict."""
    from robustpointclouds_tpu.cli import evaluate_nuscenes_adversarial as jev
    from robustpointclouds_tpu.train.centerpoint_loop import CenterPointTrainer as JTrainer

    from robustpointclouds_tpu_torch.cli import evaluate_nuscenes_adversarial as tev
    from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
    from robustpointclouds_tpu_torch.models.centerpoint import CenterPointConfig
    from robustpointclouds_tpu_torch.tools.convert import centerpoint_to_state_dict
    from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer
    from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager
    from robustpointclouds_tpu_torch.train.loop import TrainConfig

    args = argparse.Namespace(data_root=FIXTURE, synthetic=False, tiny=True, frames=1,
                              batch_size=1, limit=None, pretrained=None, allow_random_init=True)
    states = []  # the random init _evaluate scores
    init_state = JTrainer.init_state
    monkeypatch.setattr(JTrainer, "init_state",
                        lambda self, *a: states.append(init_state(self, *a)) or states[-1])
    ref = jev._evaluate(str(tmp_path / "no_ckpt"), args, attack=False)
    (state,) = states
    tr = CenterPointTrainer(tiny_centerpoint_cfg(CenterPointConfig())[0], TrainConfig(),
                            device="cpu")
    tr.init_state(state_dict=centerpoint_to_state_dict(state.params, state.batch_stats))
    CheckpointManager(str(tmp_path / "converted")).save(0, tr)

    res = tev.main(["--mode", "clean", "--tiny", "--cpu", "--data-root", FIXTURE,
                    "--checkpoint", str(tmp_path / "converted")])
    got = res["clean"]
    assert got is not None and sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6, err_msg=k)
    # and the adversarial mode runs the learned attack on the same frames
    adv = tev.main(["--mode", "adversarial", "--tiny", "--cpu", "--data-root", FIXTURE,
                    "--checkpoint", str(tmp_path / "converted")])["adversarial"]
    assert adv is not None and "mAP" in adv and "NDS" in adv


def test_eval_cli_on_synthetic_frames_prefixes_every_key(tmp_path):
    from robustpointclouds_tpu_torch.cli import evaluate_nuscenes_adversarial as tev

    res = tev.main(["--mode", "clean", "--tiny", "--cpu", "--synthetic", "--frames", "2",
                    "--batch-size", "2", "--allow-random-init", "--work-dir",
                    str(tmp_path / "none")])["clean"]
    assert res and all(k.startswith("SYNTHETIC_") for k in res)
    # no checkpoint and no permission to score a random init: that mode fails
    assert tev.main(["--mode", "clean", "--tiny", "--cpu", "--synthetic", "--work-dir",
                     str(tmp_path / "none")])["clean"] is None


def test_train_cli_on_the_fixture_writes_and_resumes(tmp_path):
    from robustpointclouds_tpu_torch.cli import evaluate_adversarial_checkpoint as ckpt_eval
    from robustpointclouds_tpu_torch.cli import train_nuscenes_adversarial as cli

    wd = str(tmp_path / "wd")
    common = ["--tiny", "--cpu", "--data-root", FIXTURE, "--work-dir", wd]
    out = cli.main(common + ["--steps", "2", "--batch-size", "2"])
    assert sorted(f for f in os.listdir(wd) if f.endswith(".pt")) == ["epoch_0.pt"]
    assert os.path.isfile(os.path.join(wd, "l2_norms.csv"))
    assert out["state"].step == 2 and np.isfinite(out["history"]["wall_time_s"])
    first = torch.load(os.path.join(wd, "epoch_0.pt"), weights_only=True)
    out = cli.main(common + ["--resume", "--epochs", "2", "--steps-per-epoch", "2",
                             "--batch-size", "2"])
    assert out["start_epoch"] == 1 and out["state"].step == 4
    assert os.path.isfile(os.path.join(wd, "epoch_1.pt"))
    assert first["train_state"]["step"] == 2
    # the newest checkpoint scores through evaluate_adversarial_checkpoint
    res = ckpt_eval.main(["--work-dir", wd, "--tiny", "--cpu", "--data-root", FIXTURE])
    assert res is not None and "NDS" in res
    # --validate scores the val split every 2 epochs and keeps the best checkpoint
    out = cli.main(["--tiny", "--cpu", "--data-root", FIXTURE, "--work-dir", str(tmp_path / "v"),
                    "--validate", "--epochs", "2", "--steps-per-epoch", "1"])
    assert "NDS" in out["history"]["val_epoch1"]
    assert os.path.isfile(os.path.join(str(tmp_path / "v"), "best.pt"))


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    from robustpointclouds_tpu_torch.cli import train_nuscenes_adversarial as cli

    # zoo .pth warm starts are ported: the flag parses, a missing file raises
    assert cli.parse_args(["--pretrained", "zoo.pth"]).pretrained == "zoo.pth"
    with pytest.raises(FileNotFoundError):
        cli.run(work_dir=str(tmp_path), pretrained=str(tmp_path / "zoo.pth"), tiny=True,
                synthetic=True, max_steps=1, device="cpu")
    with pytest.raises(TypeError):  # the port trains over a process group, run(group=...)
        cli.run(work_dir=str(tmp_path), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):  # PGD-AT is anchor-head only, as in JAX
        from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer
        from robustpointclouds_tpu_torch.train.loop import TrainConfig

        CenterPointTrainer(train_cfg=TrainConfig(pgd_steps=2), device="cpu")


def test_cli_warm_starts_from_a_zoo_pth(tmp_path, capsys):
    """--pretrained a CenterPoint .pth with the DCN head into the CLIs'
    plain-head model: the trunk, the shared conv and each task's heatmap and
    regression branches load, the 12 DCN adaptations (cls, reg x 6 tasks)
    are skipped as missing, as in JAX; training and evaluation run on it."""
    from zoo_checkpoint import fake_zoo_state_dict, save_pth

    from robustpointclouds_tpu_torch.cli import evaluate_nuscenes_adversarial as tev
    from robustpointclouds_tpu_torch.cli import train_nuscenes_adversarial as cli
    from robustpointclouds_tpu_torch.models.centerpoint import CenterPointConfig
    from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer

    dcn_cfg, _ = cli.tiny_centerpoint_cfg(CenterPointConfig(use_dcn_head=True))
    shapes = CenterPointTrainer(dcn_cfg, device="cpu").model.state_dict()
    pth = save_pth(fake_zoo_state_dict(shapes, seed=9), str(tmp_path / "centerpoint.pth"))
    line = f"[load-from] {pth} (centerpoint): loaded 382 tensors, skipped 12"
    out = cli.main(["--tiny", "--cpu", "--synthetic", "--steps", "1", "--pretrained", pth,
                    "--work-dir", str(tmp_path / "wd")])
    assert line in capsys.readouterr().out and out["state"].step == 1
    res = tev.main(["--mode", "clean", "--tiny", "--cpu", "--synthetic", "--frames", "2",
                    "--batch-size", "2", "--pretrained", pth, "--work-dir",
                    str(tmp_path / "none")])["clean"]
    assert line in capsys.readouterr().out
    assert res and all(k.startswith("SYNTHETIC_") for k in res)
