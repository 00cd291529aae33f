"""The port stands alone: it imports neither jax nor the JAX package, opens
no path outside its own package but the build directory, and its entry
points refuse to fall back to the CPU when no card is there."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import robustpointclouds_tpu_torch
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

PKG_DIR = os.path.dirname(robustpointclouds_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)

_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
import robustpointclouds_tpu_torch as pkg
have_triton = importlib.util.find_spec("triton") is not None
names = []
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if m.name.endswith("masked_stats_triton") and not have_triton:
        continue  # imports triton at the top; imported only where it launches
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "robustpointclouds_tpu"
             or k.startswith("robustpointclouds_tpu."))
print(len(names), bad, ",".join(names))
"""

# every module of the port, the training slice's included, must import clean
_EXPECTED = {
    "robustpointclouds_tpu_torch.kernels.sparse_conv", "robustpointclouds_tpu_torch.kernels.masked_stats",
    "robustpointclouds_tpu_torch.ops.assigner", "robustpointclouds_tpu_torch.ops.losses",
    "robustpointclouds_tpu_torch.train.hooks", "robustpointclouds_tpu_torch.train.loop",
    "robustpointclouds_tpu_torch.cli.common",
    "robustpointclouds_tpu_torch.cli.train_kitti_3class_adversarial",
    "robustpointclouds_tpu_torch.tools.profile_train",
    "robustpointclouds_tpu_torch.kernels.gather", "robustpointclouds_tpu_torch.tools.probe_gather",
    "robustpointclouds_tpu_torch.eval.kitti_metric", "robustpointclouds_tpu_torch.eval.attacks",
    "robustpointclouds_tpu_torch.data.kitti", "robustpointclouds_tpu_torch.train.checkpoint",
    "robustpointclouds_tpu_torch.cli.evaluate_kitti_3class",
    "robustpointclouds_tpu_torch.cli.evaluate_kitti_adversarial_attack",
    "robustpointclouds_tpu_torch.core.config", "robustpointclouds_tpu_torch.core.builders",
    "robustpointclouds_tpu_torch.core.tensorboard", "robustpointclouds_tpu_torch.data.native",
    "robustpointclouds_tpu_torch.data.transforms",
    "robustpointclouds_tpu_torch.tools.create_kitti_dbinfos",
    # the CenterPoint / NuScenes slice
    "robustpointclouds_tpu_torch.nn.center_head", "robustpointclouds_tpu_torch.nn.deform_conv",
    "robustpointclouds_tpu_torch.models.center_detection",
    "robustpointclouds_tpu_torch.models.centerpoint",
    "robustpointclouds_tpu_torch.train.centerpoint_loop",
    "robustpointclouds_tpu_torch.data.nuscenes", "robustpointclouds_tpu_torch.eval.nuscenes_metric",
    "robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial",
    "robustpointclouds_tpu_torch.cli.evaluate_nuscenes_adversarial",
    "robustpointclouds_tpu_torch.cli.evaluate_adversarial_checkpoint",
    # the PointPillars slice and the generic entry point
    "robustpointclouds_tpu_torch.models.pointpillars", "robustpointclouds_tpu_torch.cli.train",
    # the strong family
    "robustpointclouds_tpu_torch.core.registry", "robustpointclouds_tpu_torch.models.strong",
    "robustpointclouds_tpu_torch.train.strong_loop",
    "robustpointclouds_tpu_torch.cli.train_kitti_adversarial_strong",
    # the inline (plan=None) path: the device plan builders and their callers
    "robustpointclouds_tpu_torch.ops.voxelize", "robustpointclouds_tpu_torch.ops.sparse",
    "robustpointclouds_tpu_torch.nn.sparse_encoder", "robustpointclouds_tpu_torch.models.voxelnet",
    "robustpointclouds_tpu_torch.cli.export",
    # the zoo warm start and the BEV visualiser
    "robustpointclouds_tpu_torch.tools.convert_torch_checkpoint",
    "robustpointclouds_tpu_torch.tools.visualize_results",
    # data parallel (torch.distributed)
    "robustpointclouds_tpu_torch.parallel", "robustpointclouds_tpu_torch.parallel.mesh",
    "robustpointclouds_tpu_torch.parallel.multihost",
    # the convergence run (M16) and the dryrun_multichip counterpart
    "robustpointclouds_tpu_torch.tools.convergence_run",
    "robustpointclouds_tpu_torch.parallel.dryrun",
    # the JAX package's env-gated variants (nn.layers: RPC_BN_BF16_STATS;
    # nn.second, whose RPC_FPN_D2S tests hold) and the CenterPoint NaN diagnosis
    "robustpointclouds_tpu_torch.nn.layers", "robustpointclouds_tpu_torch.nn.second",
    "robustpointclouds_tpu_torch.tools.diag_centerpoint_nan",
}


def test_importing_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout.split(None, 2)
    assert int(out[0]) >= 38, out
    assert out[1].strip() == "[]", out
    assert _EXPECTED <= set(out[2].strip().split(",")), out


_WARM_START = r"""
import sys
import numpy as np
from robustpointclouds_tpu_torch.tools import convert_torch_checkpoint as cvt
from robustpointclouds_tpu_torch.tools import visualize_results
from robustpointclouds_tpu_torch.train import checkpoint
sd = {"middle_encoder.conv_input.0.weight": np.zeros((16, 3, 3, 3, 4), np.float32)}
sd.update({f"middle_encoder.conv_input.1.{k}": np.ones(16, np.float32)
           for k in ("weight", "bias", "running_mean", "running_var")})
assert cvt.detect_state_dict_layout(sd) == "second"
assert len(cvt.convert_second_state_dict(sd)) == 5
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "robustpointclouds_tpu"
             or k.startswith("robustpointclouds_tpu."))
print(bad, "matplotlib" in sys.modules)
"""


def test_warm_start_and_visualiser_load_no_jax():
    """The two M11 modules and the warm start's caller import and convert
    without jax or the JAX package; the visualiser leaves matplotlib to main."""
    out = subprocess.run([sys.executable, "-c", _WARM_START], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[] False", out


def test_no_source_file_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+(jax|flax|robustpointclouds_tpu)(\.|\s|$)", re.M)
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        offenders.append(path)
    assert offenders == []


def test_no_source_reaches_outside_the_package_but_build():
    from robustpointclouds_tpu_torch.data import native, native_plan
    from robustpointclouds_tpu_torch.kernels import _build

    # the native sources it compiles are its own ...
    assert _build.CSRC_DIR == os.path.join(PKG_DIR, "csrc")
    for mod, name in ((native_plan, "plan.cpp"), (native, "pointcloud.cpp")):
        assert mod._SRC == os.path.join(PKG_DIR, "csrc", name)
        with open(mod._SRC, "rb") as a, open(os.path.join(REPO, "csrc", name), "rb") as b:
            assert a.read() == b.read()  # a byte-for-byte copy of the JAX package's source
    # ... and their builds go to the git-ignored build/ at the repo root
    for d in (native_plan._BUILD_DIR, native._BUILD_DIR, _build.BUILD_DIR):
        assert os.path.relpath(d, REPO).split(os.sep)[0] == "build"
    # every path built upward from a source file's own location names build/
    up = re.compile(r"dirname\(\s*_PKG\s*\)|_REPO_ROOT|os\.pardir|['\"]\.\.['\"]|"
                    r"dirname\(os\.path\.dirname\(os\.path\.dirname")
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    offenders += [f"{path}:{i}" for i, line in enumerate(fh, 1)
                                  if up.search(line) and '"build"' not in line]
    assert offenders == []


def test_entry_points_raise_without_a_card(monkeypatch):
    from robustpointclouds_tpu_torch.cli.export import export_serving
    from robustpointclouds_tpu_torch.core.device import resolve_device
    from robustpointclouds_tpu_torch.models.voxelnet import AdversarialVoxelNet, VoxelNetConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    cfg = VoxelNetConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_serving(AdversarialVoxelNet(cfg), None, np.zeros((1, 7), np.float32), cfg.head)
    assert resolve_device("cpu") == torch.device("cpu")
    # the CenterPoint entry points: serving, training and both evaluation CLIs
    from robustpointclouds_tpu_torch.cli import (evaluate_adversarial_checkpoint,
                                                 evaluate_nuscenes_adversarial,
                                                 train_nuscenes_adversarial)
    from robustpointclouds_tpu_torch.models.centerpoint import (AdversarialCenterPoint,
                                                                CenterPointConfig)

    cp = CenterPointConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_serving(AdversarialCenterPoint(cp), None, None, cp.head)
    for main in (train_nuscenes_adversarial.main, evaluate_nuscenes_adversarial.main,
                 evaluate_adversarial_checkpoint.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--tiny", "--synthetic"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_nuscenes_adversarial.run(tiny=True, synthetic=True)


def test_the_inline_path_never_calls_the_host_builder(monkeypatch):
    """plan=None builds on the points' device: with the native builders made
    to raise, every family's inline forward still runs (on CPU tensors)."""
    from robustpointclouds_tpu_torch.cli.common import tiny_pointpillars_cfg, tiny_voxelnet_cfg
    from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
    from robustpointclouds_tpu_torch.data import native_plan
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
    from robustpointclouds_tpu_torch.models import centerpoint, pointpillars, strong, voxelnet

    def refuse(*a, **k):
        raise AssertionError("the host plan builder was called")

    for name in ("build_plan_native", "build_pillar_plan_native"):
        monkeypatch.setattr(native_plan, name, refuse)
        for mod in (voxelnet, centerpoint, pointpillars, strong):
            assert not hasattr(mod, name), (mod.__name__, name)  # no model holds a host builder
    b = synthetic_kitti_batch(np.random.RandomState(0), batch_size=2, num_points=512, max_gt=8,
                              num_objects=3, point_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0))
    pts, msk = torch.from_numpy(np.asarray(b.points)), torch.from_numpy(np.asarray(b.points_mask))
    cp_cfg, _ = tiny_centerpoint_cfg(centerpoint.CenterPointConfig(compute_dtype="float32"))
    models = [voxelnet.AdversarialVoxelNet(tiny_voxelnet_cfg()._replace(compute_dtype="float32")),
              pointpillars.AdversarialPointPillars(
                  tiny_pointpillars_cfg()._replace(compute_dtype="float32")),
              strong.StrongAdversarialVoxelNet(strong.StrongVoxelNetConfig(
                  base=tiny_voxelnet_cfg()._replace(adversary=None, compute_dtype="float32")))]
    models.append(centerpoint.AdversarialCenterPoint(cp_cfg))
    for m in models:
        voxelnet.init_weights(m, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in models[:3]:
            assert torch.isfinite(m(pts, msk, False).cls_scores).all()
        cp_pts = torch.cat([pts, torch.zeros_like(pts[..., :1])], -1)
        out = models[3](cp_pts, msk, False)
        assert torch.isfinite(out.task_preds[0]["heatmap"]).all()
