"""Data-parallel training through the port's entry points, on the CPU over gloo (after tests/test_multihost.py).

  * two processes of `python -m robustpointclouds_tpu_torch.cli.train
    <tiny SECOND config> --multihost --cpu --synthetic --steps-per-epoch 2`,
    met through a rendezvous file under tmp_path: both exit 0, process 0
    alone writes its checkpoint and train_log.jsonl, and both end on the
    same state (the digest each prints);
  * `--devices 2 --cpu` on the tiny pillar config runs through the spawn
    path of cli/train, and on the KITTI CLI's --tiny model;
  * CenterPoint: cli/train_nuscenes_adversarial.run(group=...) in two
    spawned ranks takes 2 steps on tests/fixtures/nuscenes_mini.
"""
import json
import os
import re
import subprocess
import sys

import torch.distributed as dist

from robustpointclouds_tpu_torch.cli import train as train_cli
from robustpointclouds_tpu_torch.cli import train_kitti_3class_adversarial as kitti_cli
from robustpointclouds_tpu_torch.cli.common import picklable_result
from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import run as nus_run
from robustpointclouds_tpu_torch.parallel.multihost import launch_local
from robustpointclouds_tpu_torch.train.checkpoint import CheckpointManager
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
CONFIGS = os.path.join(REPO, "configs")
NUSCENES_MINI = os.path.join(TESTS, "fixtures", "nuscenes_mini")

# the SECOND config on the CLIs' --tiny grid at global B=4 (tests/test_multihost.py's)
TINY_SECOND = """
_base_ = ['{base}']
model = dict(
    voxelizer=dict(point_cloud_range=[0.0, -8.0, -3.0, 16.0, 8.0, 1.0],
                   voxel_size=[0.5, 0.5, 0.125], max_points_per_voxel=3, max_voxels=256),
    bbox_head=dict(anchor_ranges=[[0, -8.0, -0.6, 16.0, 8.0, -0.6],
                                  [0, -8.0, -0.6, 16.0, 8.0, -0.6],
                                  [0, -8.0, -0.6, 16.0, 8.0, -0.6]]),
)
max_epochs = 1
val_interval = 5
batch_size = 4
"""
# the pillar config on a 16 m grid of 0.5 m pillars (tests/test_torch_generic_cli.py's)
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
batch_size = 4
"""


def _write(tmp_path, text, base):
    path = tmp_path / "tiny.py"
    path.write_text(text.format(base=base))
    return str(path)


def _digests(text):
    return re.findall(r"replicas equal, state sha256 ([0-9a-f]{64})", text)


def test_two_process_multihost_cli(tmp_path):
    cfg = _write(tmp_path, TINY_SECOND, os.path.join(CONFIGS, "_base_", "kitti-3d-3class.py"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "robustpointclouds_tpu_torch.cli.train", cfg, "--cpu",
             "--synthetic", "--multihost", "--coordinator", f"file://{tmp_path / 'rdzv'}",
             "--num-processes", "2", "--process-id", str(pid), "--steps-per-epoch", "2",
             "--work-dir", str(tmp_path / f"wd{pid}")],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
    assert "[multihost] process 0/2, gloo" in outs[0]
    assert "[multihost] process 1/2, gloo" in outs[1]
    # process 0 alone writes: one checkpoint, one train log
    assert CheckpointManager(str(tmp_path / "wd0")).epochs() == [0]
    assert CheckpointManager(str(tmp_path / "wd1")).epochs() == []
    rows = [json.loads(line) for line in (tmp_path / "wd0" / "train_log.jsonl").read_text()
            .splitlines()]
    assert len(rows) == 1 and rows[0]["loss"] == rows[0]["loss"]  # step 1 (log_interval 50)
    assert not (tmp_path / "wd1" / "train_log.jsonl").exists()
    # both ranks end on the same parameters, buffers and train state
    d0, d1 = _digests(outs[0]), _digests(outs[1])
    assert len(d0) == len(d1) == 1 and d0 == d1


def test_devices_spawns_local_ranks(tmp_path):
    """cli/train --devices 2 --cpu (the pillar family) and the KITTI CLI's --devices 2."""
    base = os.path.join(CONFIGS, "adversarial", "adversarial-pointpillars_kitti-3d-3class.py")
    cfg = _write(tmp_path, TINY_PILLARS, base)
    out = train_cli.main([cfg, "--devices", "2", "--cpu", "--synthetic", "--steps-per-epoch", "2",
                          "--work-dir", str(tmp_path / "pp")])
    assert out["epochs"][0]["frames"] == 2 * 4  # two steps of the global batch
    assert len(out["state_sha256"]) == 64 and "state" not in out
    assert CheckpointManager(str(tmp_path / "pp")).epochs() == [0]
    assert not [f for f in os.listdir(tmp_path / "pp") if f.startswith(".rendezvous")]

    out = kitti_cli.main(["--devices", "2", "--cpu", "--tiny", "--synthetic", "--steps", "2",
                          "--batch-size", "4", "--work-dir", str(tmp_path / "kitti")])
    assert out["epochs"][0]["frames"] == 8 and out["history"]["final_epoch"] == 0
    assert CheckpointManager(str(tmp_path / "kitti")).epochs() == [0]


def _nuscenes_rank(rank, world, work_dir):
    out = nus_run(work_dir=work_dir, data_root=NUSCENES_MINI, batch_size=2, tiny=True,
                  max_steps=2, device="cpu", group=dist.group.WORLD)
    return picklable_result(out)


def test_nuscenes_run_over_a_process_group(tmp_path):
    work = str(tmp_path / "cp")
    r0, r1 = launch_local(_nuscenes_rank, 2, (work,), backend="gloo",
                          init_file=str(tmp_path / "rdzv"))
    assert r0["state_sha256"] == r1["state_sha256"]
    assert r0["epochs"][0]["frames"] == 2 * 2  # two steps of the global batch of 2
    assert CheckpointManager(work).epochs() == [0]
