"""The command's refusals: no result without the card it needs, and none
from a process that loaded JAX or the JAX package (top-level names
compared whole)."""
import os
import subprocess
import sys
import types

from benchmark import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "second-kitti-3class.train-inline", "--seed", str(2**31 + 5),
                          "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_forbidden_modules_compared_whole(monkeypatch):
    base = set(run.loaded_forbidden())
    monkeypatch.setitem(sys.modules, "robustpointclouds_tpu_torch_x", types.ModuleType("x"))
    assert set(run.loaded_forbidden()) == base
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "robustpointclouds_tpu.core", types.ModuleType("c"))
    assert set(run.loaded_forbidden()) >= {"jax", "robustpointclouds_tpu"}
