"""The traffic generator: the same seed gives the same batches, another seed
other values at the same sizes, and sweeps carry their lag."""
import json
import os

import numpy as np

from benchmark import scenes

TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "traffic")


def _small(name, **kw):
    with open(os.path.join(TRAFFIC, name + ".json")) as f:
        t = json.load(f)
    t.update(points_per_frame=3000, pool=3, **kw)
    return t


def test_same_seed_same_batches():
    t = _small("kitti-b6-train")
    a, b = scenes.pool(2**31 + 17, t), scenes.pool(2**31 + 17, t)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def _sweeps():
    """The KITTI mix as 10-sweep samples of 5 features, 12 moving objects."""
    return _small("kitti-b6-train", batch=4, features=5, objects=12, center_inset=8.0,
                  velocity=2.0, sweeps=10, sweep_interval_s=0.05)


def test_other_seed_other_values_same_sizes():
    t = _sweeps()
    a, b = scenes.pool(5, t), scenes.pool(2**33 + 5, t)
    for x, y in zip(a, b):
        for k in x:
            assert x[k].shape == y[k].shape and x[k].dtype == y[k].dtype
        assert not np.array_equal(x["points"], y["points"])
    assert not np.array_equal(a[0]["points"], a[1]["points"])


def test_frames_follow_the_parameters():
    t = _sweeps()
    (b,) = scenes.pool(1, dict(t, pool=1))
    assert b["points"].shape == (4, 3000, 5)
    lags = np.unique(b["points"][..., 4])
    np.testing.assert_allclose(lags, np.arange(10, dtype=np.float32) * 0.05, atol=1e-6)
    lo, hi = np.asarray(t["point_range"][:3]), np.asarray(t["point_range"][3:])
    assert b["gt_mask"].sum(1).tolist() == [12] * 4
    centers = b["gt_boxes"][b["gt_mask"]][:, :2]
    assert (centers >= lo[:2] + 8).all() and (centers <= hi[:2] - 8).all()
    assert b["points_mask"].all()
    k = _small("kitti-b6-train")
    (kb,) = scenes.pool(1, dict(k, pool=1))
    assert kb["points"].shape == (6, 3000, 4) and not kb["gt_vel"].any()
