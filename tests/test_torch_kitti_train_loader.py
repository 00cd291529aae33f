"""The port's KITTI training data path against the JAX package's, on the CPU: bit-equal.

Both sides are numpy (the transforms, GT-paste, the loader's per-object
stage) or the same C++ source built by g++ (the native pipeline), fed the
same inputs and `np.random.RandomState` seeds, so every output array is held
bit for bit (np.array_equal with equal dtypes), and every RandomState is
left in the same state. Checked:
  * each transform of data/transforms over several seeds, GT-paste's
    database (collect, paste, from_dbinfos) and augment_sample;
  * native.prepare_batch on the kitti_mini bins, with and without the
    global augmentation (the boxes are augmented in place on both sides);
  * kitti_epoch_loader on kitti_mini, B=2, the tiny config's range, 2 epochs
    x 3 steps, native and numpy paths, with and without a dbinfos file;
  * create_kitti_dbinfos: the pickle and every crop file byte for byte.
"""
import os
import shutil

import numpy as np
import pytest

from robustpointclouds_tpu.cli.common import tiny_voxelnet_cfg as j_tiny_cfg
from robustpointclouds_tpu.data import kitti as jkitti
from robustpointclouds_tpu.data import native as jnative
from robustpointclouds_tpu.data import transforms as JT
from robustpointclouds_tpu.tools.create_kitti_dbinfos import create_dbinfos as j_create_dbinfos

from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg as t_tiny_cfg
from robustpointclouds_tpu_torch.data import kitti as tkitti
from robustpointclouds_tpu_torch.data import native as tnative
from robustpointclouds_tpu_torch.data import transforms as TT
from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
from robustpointclouds_tpu_torch.tools.create_kitti_dbinfos import create_dbinfos as t_create_dbinfos
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

KITTI_MINI = os.path.join(os.path.dirname(__file__), "fixtures", "kitti_mini")
SEEDS = [0, 1, 2, 3, 4]
TINY_PCR = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)


def _sample(seed: int, num_points: int = 900, num_objects: int = 6):
    """A scene dict: points on objects and ground, GT boxes, labels, difficulty."""
    b = synthetic_kitti_batch(np.random.RandomState(seed), batch_size=1, num_points=num_points,
                              max_gt=num_objects, num_objects=num_objects, point_range=TINY_PCR)
    g = int(b.gt_mask[0].sum())
    return {"points": b.points[0], "gt_boxes": b.gt_boxes[0, :g], "gt_labels": b.gt_labels[0, :g],
            "gt_difficulty": np.zeros(g, np.int32), "frame_id": f"{seed:06d}"}


def _copy(sample):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in sample.items()}


def _same(got, ref, what=""):
    """Bit-equal nested outputs: arrays with equal dtypes and values."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), what
        for k in ref:
            _same(got[k], ref[k], f"{what}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _same(g, r, f"{what}[{i}]")
    elif isinstance(ref, np.ndarray) or hasattr(ref, "__array__"):
        g, r = np.asarray(got), np.asarray(ref)
        assert g.dtype == r.dtype and g.shape == r.shape, (what, g.dtype, r.dtype, g.shape, r.shape)
        assert np.array_equal(g, r, equal_nan=g.dtype.kind == "f"), what
    else:
        assert got == ref, what


def _same_rng(a: np.random.RandomState, b: np.random.RandomState):
    sa, sb = a.get_state(), b.get_state()
    assert sa[0] == sb[0] and np.array_equal(sa[1], sb[1]) and sa[2:] == sb[2:]


def _rngs(seed):
    return np.random.RandomState(1000 + seed), np.random.RandomState(1000 + seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_points_in_box_and_collisions(seed):
    s = _sample(seed)
    for i, box in enumerate(s["gt_boxes"]):
        for margin in (0.0, 0.3):
            _same(TT.points_in_box(s["points"], box, margin), JT.points_in_box(s["points"], box, margin))
        others = np.delete(s["gt_boxes"], i, axis=0)
        assert TT._bev_collides(box, others) == JT._bev_collides(box, others)
    assert TT._bev_collides(s["gt_boxes"][0], np.zeros((0, 7), np.float32)) is False


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["object_noise", "random_flip", "global_rot_scale_trans",
                                  "shuffle_points"])
def test_transform_matches_jax(name, seed):
    s = _sample(seed)
    rt, rj = _rngs(seed)
    got = getattr(TT, name)(_copy(s), rt)
    ref = getattr(JT, name)(_copy(s), rj)
    _same(got, ref, name)
    _same_rng(rt, rj)
    if name in ("object_noise", "global_rot_scale_trans"):
        assert not np.array_equal(got["gt_boxes"], s["gt_boxes"])  # the draw moved the boxes


@pytest.mark.parametrize("seed", SEEDS)
def test_filter_range_matches_jax(seed):
    s = _sample(seed)
    s["points"][::7, 0] += 20.0  # some points and a box centre out of range
    s["gt_boxes"][0, 0] = -3.0
    _same(TT.filter_range(_copy(s), TINY_PCR), JT.filter_range(_copy(s), TINY_PCR))


def _fill(db_t, db_j, seeds):
    for seed in seeds:
        s = _sample(seed)
        db_t.collect(_copy(s))
        db_j.collect(_copy(s))
    _same(db_t._db, db_j._db, "db")


@pytest.mark.parametrize("seed", SEEDS)
def test_gt_paste_matches_jax(seed):
    db_t, db_j = TT.GroundTruthDatabase(), JT.GroundTruthDatabase()
    _fill(db_t, db_j, [10 + seed, 20 + seed, 30 + seed])
    assert sum(len(v) for v in db_t._db.values()) > 0
    s = _sample(seed, num_objects=2)
    rt, rj = _rngs(seed)
    got, ref = db_t.paste(_copy(s), rt), db_j.paste(_copy(s), rj)
    _same(got, ref, "paste")
    _same_rng(rt, rj)
    assert len(got["gt_boxes"]) > len(s["gt_boxes"])  # crops were pasted


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("with_db", [False, True])
def test_augment_sample_matches_jax(seed, with_db):
    db_t, db_j = (TT.GroundTruthDatabase(), JT.GroundTruthDatabase()) if with_db else (None, None)
    if with_db:
        _fill(db_t, db_j, [40 + seed, 50 + seed])
    s = _sample(seed)
    rt, rj = _rngs(seed)
    _same(TT.augment_sample(_copy(s), rt, TINY_PCR, gt_db=db_t),
          JT.augment_sample(_copy(s), rj, TINY_PCR, gt_db=db_j))
    _same_rng(rt, rj)


def test_create_dbinfos_matches_jax(tmp_path):
    ref = j_create_dbinfos(KITTI_MINI, out_dir=str(tmp_path / "j"))
    got = t_create_dbinfos(KITTI_MINI, out_dir=str(tmp_path / "t"))
    _same(got, ref)
    assert sum(len(v) for v in got.values()) > 0
    with open(tmp_path / "j" / "kitti_dbinfos_train.pkl", "rb") as a, \
            open(tmp_path / "t" / "kitti_dbinfos_train.pkl", "rb") as b:
        assert a.read() == b.read()
    crops_j = sorted(os.listdir(tmp_path / "j" / "kitti_gt_database"))
    assert crops_j == sorted(os.listdir(tmp_path / "t" / "kitti_gt_database")) and crops_j
    for name in crops_j:
        with open(tmp_path / "j" / "kitti_gt_database" / name, "rb") as a, \
                open(tmp_path / "t" / "kitti_gt_database" / name, "rb") as b:
            assert a.read() == b.read(), name


def test_from_dbinfos_matches_jax(tmp_path):
    j_create_dbinfos(KITTI_MINI, out_dir=str(tmp_path))
    pkl = str(tmp_path / "kitti_dbinfos_train.pkl")
    got = TT.GroundTruthDatabase.from_dbinfos(pkl, str(tmp_path))
    ref = JT.GroundTruthDatabase.from_dbinfos(pkl, str(tmp_path))
    _same(got._db, ref._db)
    assert sum(len(v) for v in got._db.values()) > 0
    assert tkitti.load_infos_pkl(pkl).keys() == jkitti.load_infos_pkl(pkl).keys()


def _mini_paths():
    ds = tkitti.KittiDataset(KITTI_MINI, split="train")
    return [os.path.join(ds._vdir, f"{fid}.bin") for fid in ds.ids], ds


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_native_prepare_batch_matches_jax(augment, seed):
    paths, ds = _mini_paths()
    boxes = np.zeros((len(paths), 8, 7), np.float32)
    n_boxes = np.zeros(len(paths), np.int32)
    for b in range(len(paths)):
        g = ds.get(b)["gt_boxes"]
        boxes[b, :len(g)] = g
        n_boxes[b] = len(g)
    bt, bj = boxes.copy(), boxes.copy()
    got = tnative.prepare_batch(paths, bt, n_boxes, TINY_PCR, max_points=700, seed=seed,
                                augment=augment)
    ref = jnative.prepare_batch(paths, bj, n_boxes, TINY_PCR, max_points=700, seed=seed,
                                augment=augment)
    _same(got, ref, "prepare_batch")
    _same(bt, bj, "boxes in place")
    assert np.array_equal(bt, boxes) != augment  # the augmentation moved the boxes
    assert (got[3] > 0).all() and got[1].sum() == got[3].sum()
    _same(tnative.load_points(paths[0]), jkitti.read_points(paths[0]))


@pytest.mark.parametrize("with_db", [False, True], ids=["no-dbinfos", "dbinfos"])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_epoch_loader_matches_jax(tmp_path, use_native, with_db, capsys):
    root = KITTI_MINI
    if with_db:
        root = str(tmp_path / "kitti")
        shutil.copytree(KITTI_MINI, root)
        j_create_dbinfos(root)
    kw = dict(seed=3, steps_per_epoch=3, num_points=512, use_native=use_native)
    got_loader = tkitti.kitti_epoch_loader(root, 2, t_tiny_cfg(), **kw)
    ref_loader = jkitti.kitti_epoch_loader(root, 2, j_tiny_cfg(), **kw)
    n = 0
    for epoch in range(2):
        for got, ref in zip(got_loader(epoch), ref_loader(epoch)):
            _same(tuple(got), tuple(np.asarray(x) for x in ref), f"epoch {epoch}")
            assert got.points_mask.sum() > 0 and got.gt_mask.sum() > 0
            n += 1
    assert n == 6
    assert ("[gt-paste] seeded" in capsys.readouterr().out) == with_db


def test_native_loader_raises_when_the_library_cannot_be_built(tmp_path, monkeypatch):
    import subprocess

    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", str(bad))
    monkeypatch.setattr(tnative, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_SO", str(tmp_path / "build" / "libpointcloud.so"))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(subprocess.CalledProcessError):
        tkitti.kitti_epoch_loader(KITTI_MINI, 2, t_tiny_cfg())
    # the numpy path, asked for explicitly, needs no library
    batch = next(tkitti.kitti_epoch_loader(KITTI_MINI, 2, t_tiny_cfg(), use_native=False)(0))
    assert batch.points.shape == (2, 20000, 4) and batch.points_mask.any()


def test_epoch_loader_wraps_past_a_small_split():
    loader = tkitti.kitti_epoch_loader(KITTI_MINI, 5, t_tiny_cfg(), steps_per_epoch=1)
    batch = next(loader(0))
    assert batch.points.shape[0] == batch.gt_boxes.shape[0] == 5
    assert batch.points_mask.any(axis=1).all()
