"""The port's BEV visualiser (tools/visualize_results.py) on the CPU, matplotlib's Agg backend.

  * draw_bev puts the same scatter offsets, line data and colours, score
    texts and axis limits on an axes as the JAX package's draw_bev for the
    same points and boxes;
  * main(--tiny --cpu --synthetic) restores a port checkpoint and writes
    --frames PNGs, `frame_{i:03d}_{clean|attack}.png`;
  * without matplotlib, main raises instead of carrying on without the PNGs.
"""
import sys

import matplotlib
import numpy as np
import pytest

from robustpointclouds_tpu.tools import visualize_results as jvis

from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg
from robustpointclouds_tpu_torch.tools import visualize_results as tvis
from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager
from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

matplotlib.use("Agg")


def _axes_data(ax):
    return dict(
        scatter=[np.asarray(c.get_offsets()) for c in ax.collections],
        lines=[(np.asarray(l.get_xydata()), l.get_color(), l.get_linewidth()) for l in ax.lines],
        texts=[(t.get_position(), t.get_text(), t.get_color()) for t in ax.texts],
        limits=(ax.get_xlim(), ax.get_ylim()), aspect=ax.get_aspect())


def test_draw_bev_matches_jax():
    import matplotlib.pyplot as plt

    rng = np.random.RandomState(0)
    points = rng.uniform(-8, 8, (300, 4)).astype(np.float32)
    gt = np.concatenate([rng.uniform(-6, 6, (3, 3)), rng.uniform(1, 4, (3, 3)),
                         rng.uniform(-3, 3, (3, 1))], 1).astype(np.float32)
    dt = gt[:2] + 0.1
    scores = np.array([0.91, 0.42], np.float32)
    got = []
    for draw in (tvis.draw_bev, jvis.draw_bev):
        fig, ax = plt.subplots()
        draw(ax, points, gt, dt, scores, point_range=(-8, -8, 8, 8))
        got.append(_axes_data(ax))
        plt.close(fig)
    port, ref = got
    assert len(port["lines"]) == 5 and len(port["texts"]) == 2
    for a, b in zip(port["scatter"], ref["scatter"]):
        np.testing.assert_array_equal(a, b)
    for (a, ca, wa), (b, cb, wb) in zip(port["lines"], ref["lines"]):
        np.testing.assert_array_equal(a, b)
        assert (ca, wa) == (cb, wb)
    assert port["texts"] == ref["texts"] and port["limits"] == ref["limits"]
    assert port["aspect"] == ref["aspect"]


@pytest.mark.parametrize("attack", [False, True])
def test_main_renders_frames_from_a_port_checkpoint(tmp_path, capsys, attack):
    tr = Trainer(tiny_voxelnet_cfg(), TrainConfig(), device="cpu")
    tr.init_state(3)
    CheckpointManager(str(tmp_path / "wd")).save(0, tr)
    out = tmp_path / "vis"
    paths = tvis.main(["--work-dir", str(tmp_path / "wd"), "--out", str(out), "--frames", "2",
                       "--synthetic", "--tiny", "--cpu"] + (["--attack"] if attack else []))
    mode = "attack" if attack else "clean"
    assert paths == [str(out / f"frame_{i:03d}_{mode}.png") for i in range(2)]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert "[vis] restored epoch 0" in capsys.readouterr().out


def test_main_without_matplotlib_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        tvis.main(["--out", str(tmp_path / "vis"), "--tiny", "--cpu", "--synthetic"])
    assert not (tmp_path / "vis").exists()
