"""The port's serving export (cli/export.py): each family's artifact.

On the CPU, in float32 at the smoke grids (SECOND and PointPillars on the
16 m grid, CenterPoint on the 25.6 m grid):
  * each family's artifact, exported on the CPU, saved and loaded, returns
    outputs bit-equal (dtype and shape too) to the eager
    `export_serving(...)(points, mask)` on seeded frames;
  * its graph holds one rpc::sparse_conv_fwd node per sparse conv and one
    rpc::masked_bn_apply node per MaskedBatchNorm outside the adversary
    (clean serving never runs the adversary);
  * SECOND's plan-fed artifact, fed the native host plan, equals the
    self-contained one (JAX's tests/test_export.py);
  * each family's loaded artifact agrees with the JAX package's artifact
    (robustpointclouds_tpu/cli/export.py) of the same weights (JAX's
    initial state, carried over by tools/convert; SECOND and PointPillars
    with their adversaries, which clean serving does not run): `valid` and `labels`
    exactly, scores and boxes within RTOL = ATOL = 1e-4, the serving
    tolerance of tests/test_torch_serving.py (float32 summation order
    through the sparse encoder, the dense body and the BN chain).
The CLI and the operators' opcheck: tests/test_torch_export_cli.py. The
card's side (the operators bit-equal to the direct launches, the artifact
launching the kernels as often as the eager serve, none while exporting):
tests/test_torch_kernels_cuda.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.cli import export as jexport
from robustpointclouds_tpu.cli.common import tiny_voxelnet_cfg as j_tiny_voxelnet_cfg
from robustpointclouds_tpu.cli.train_nuscenes_adversarial import (
    tiny_centerpoint_cfg as j_tiny_centerpoint_cfg)
from robustpointclouds_tpu.data import synthetic_kitti_batch as j_synthetic_kitti_batch
from robustpointclouds_tpu.data.nuscenes import synthetic_nuscenes_batch as j_synthetic_nuscenes
from robustpointclouds_tpu.data.structures import PointCloudBatch as JBatch
from robustpointclouds_tpu.models.centerpoint import CenterPointConfig as JCenterPointConfig
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig, Trainer as JTrainer
from robustpointclouds_tpu.train.centerpoint_loop import CenterPointTrainer as JCenterPointTrainer

from robustpointclouds_tpu_torch.cli import export as texport
from robustpointclouds_tpu_torch.cli.common import tiny_pointpillars_cfg, tiny_voxelnet_cfg
from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
from robustpointclouds_tpu_torch.models import centerpoint as tcp
from robustpointclouds_tpu_torch.models import pointpillars as tpp
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.nn.layers import MaskedBatchNorm
from robustpointclouds_tpu_torch.nn.sparse_encoder import SparseConv3d
from robustpointclouds_tpu_torch.tools.convert import (
    centerpoint_to_state_dict, jax_to_state_dict, pointpillars_to_state_dict)
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)
from test_pointpillars import tiny_pp_cfg as j_tiny_pp_cfg

RTOL, ATOL = 1e-4, 1e-4
BATCH = 2
KITTI_POINTS = 600
# rpc::sparse_conv_fwd and rpc::masked_bn_apply nodes of each family's
# clean serving graph: every sparse conv, and every MaskedBatchNorm outside
# the adversary (the models hold 17 / 6 / 26 with the adversary's 5)
OP_NODES = {"second": (12, 12), "pointpillars": (0, 1), "centerpoint": (21, 21)}


def _op_nodes(ep):
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    return (sum(t == "rpc.sparse_conv_fwd.default" for t in targets),
            sum(t == "rpc.masked_bn_apply.default" for t in targets))


def _roundtrip(tmp, name, model, anchors, head, num_points, use_plan=False):
    ep, meta = texport.export_program(model, anchors, head, BATCH, num_points,
                                      use_plan=use_plan, device="cpu")
    path = str(tmp / f"{name}.pt2")
    nbytes = texport.save_exported(ep, meta, path)
    call, meta2 = texport.load_exported(path)
    return dict(ep=ep, meta=meta, meta2=meta2, nbytes=nbytes, call=call, path=path)


def _kitti_frames(cfg, seed):
    b = synthetic_kitti_batch(np.random.RandomState(seed), batch_size=BATCH,
                              num_points=KITTI_POINTS, max_gt=4, num_objects=3,
                              point_range=cfg.voxelizer.point_cloud_range)
    return np.asarray(b.points), np.asarray(b.points_mask)


def _jax_artifact(tmp, name, trainer, batch, num_points):
    """JAX's initial state of `trainer` with its BN statistics randomised,
    and JAX's own artifact of it, exported, saved and loaded."""
    state = trainer.init_state(jax.random.PRNGKey(0), JBatch(*(jnp.asarray(x) for x in batch)))
    state = _randomise_jax_bn(state, np.random.RandomState(1))
    jex, jmeta = jexport.export_serving(trainer, state, batch_size=BATCH, num_points=num_points)
    path = str(tmp / f"{name}.jaxexp")
    jexport.save_exported(jex, jmeta, path)
    return state, jmeta, jexport.load_exported(path)[0]


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """Each family at float32 with a low score threshold, so random weights
    keep detections, on the JAX package's initial weights (BN statistics
    randomised), each exported by both packages. Each with its artifact and
    a request of seeded frames."""
    import robustpointclouds_tpu.nn.perturber as jprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setenv("RPC_CP_REMAT", "0")
    tmp = tmp_path_factory.mktemp("export")
    torch.backends.cudnn.allow_tf32 = False
    out = {}

    # SECOND: the smoke grid at its real widths, the adversary included
    jcfg = j_tiny_voxelnet_cfg()._replace(compute_dtype="float32")
    jcfg = jcfg._replace(head=jcfg.head._replace(score_thr=0.0))
    b = j_synthetic_kitti_batch(np.random.RandomState(0), BATCH, KITTI_POINTS,
                                point_range=jcfg.voxelizer.point_cloud_range)
    state, jmeta, jcall = _jax_artifact(tmp, "second", JTrainer(model_cfg=jcfg,
                                                                train_cfg=JTrainConfig()),
                                        b, KITTI_POINTS)
    cfg = tiny_voxelnet_cfg()._replace(compute_dtype="float32")
    model = tvn.AdversarialVoxelNet(cfg)
    model.load_state_dict(jax_to_state_dict(state.params, state.batch_stats))
    anchors, _ = cfg.make_anchors()
    head = cfg.head._replace(score_thr=0.0)
    out["second"] = dict(model=model, anchors=anchors, head=head, jcall=jcall, jmeta=jmeta,
                         frames=_kitti_frames(cfg, 1),
                         **_roundtrip(tmp, "second", model, anchors, head, KITTI_POINTS))

    # PointPillars: JAX's tiny pillar config (tests/test_pointpillars.py),
    # which the port's smoke config equals
    jcfg = j_tiny_pp_cfg()._replace(compute_dtype="float32")
    jcfg = jcfg._replace(head=jcfg.head._replace(score_thr=0.0))
    b = j_synthetic_kitti_batch(np.random.RandomState(0), BATCH, KITTI_POINTS,
                                point_range=jcfg.voxelizer.point_cloud_range)
    state, jmeta, jcall = _jax_artifact(tmp, "pointpillars", JTrainer(model_cfg=jcfg,
                                                                      train_cfg=JTrainConfig()),
                                        b, KITTI_POINTS)
    cfg = tiny_pointpillars_cfg()._replace(compute_dtype="float32")
    model = tpp.AdversarialPointPillars(cfg)
    model.load_state_dict(pointpillars_to_state_dict(state.params, state.batch_stats))
    anchors, _ = cfg.make_anchors()
    head = cfg.head._replace(score_thr=0.0)
    out["pointpillars"] = dict(model=model, anchors=anchors, head=head, jcall=jcall, jmeta=jmeta,
                               frames=_kitti_frames(cfg, 1),
                               **_roundtrip(tmp, "pointpillars", model, anchors, head,
                                            KITTI_POINTS))

    jcfg, npts = j_tiny_centerpoint_cfg(JCenterPointConfig(compute_dtype="float32"))
    jcfg = jcfg._replace(head=jcfg.head._replace(score_thr=0.0))
    b, _ = j_synthetic_nuscenes(np.random.RandomState(0), batch_size=BATCH, num_points=npts,
                                max_gt=jcfg.head.max_objs,
                                point_range=jcfg.voxelizer.point_cloud_range)
    state, jmeta, jcall = _jax_artifact(tmp, "centerpoint", JCenterPointTrainer(model_cfg=jcfg),
                                        b, npts)
    cfg, _ = tiny_centerpoint_cfg(tcp.CenterPointConfig(compute_dtype="float32"))
    head = cfg.head._replace(score_thr=0.0)
    model = tcp.AdversarialCenterPoint(cfg)
    model.load_state_dict(centerpoint_to_state_dict(state.params, state.batch_stats))
    frames = synthetic_nuscenes_batch(np.random.RandomState(2), batch_size=BATCH,
                                      num_points=npts, max_gt=cfg.head.max_objs,
                                      point_range=cfg.voxelizer.point_cloud_range)[0]
    out["centerpoint"] = dict(model=model, anchors=None, head=head, jcall=jcall, jmeta=jmeta,
                              frames=(np.asarray(frames.points), np.asarray(frames.points_mask)),
                              **_roundtrip(tmp, "centerpoint", model, None, head, npts))
    yield out
    mp.undo()


def _randomise_jax_bn(state, rng):
    """The JAX state with non-trivial BN affine maps and running statistics."""
    def walk(tree, stats):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(dict(v), stats)
            elif stats and k == "var" or not stats and k == "scale":
                out[k] = jnp.asarray((0.5 + rng.rand(*np.shape(v))).astype(np.float32))
            elif (k == "mean" if stats else k == "bias") and np.ndim(v) == 1:
                out[k] = jnp.asarray((0.1 * rng.randn(*np.shape(v))).astype(np.float32))
            else:
                out[k] = v
        return out
    return state._replace(params=walk(dict(state.params), False),
                          batch_stats=walk(dict(state.batch_stats), True))


def _assert_equal(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["second", "pointpillars", "centerpoint"])
def test_artifact_equals_eager_serve(families, name):
    f = families[name]
    pts, msk = f["frames"]
    serve = texport.export_serving(f["model"], None, f["anchors"], f["head"], device="cpu")
    want = serve(pts, msk)
    got = f["call"](torch.from_numpy(pts), torch.from_numpy(msk))
    _assert_equal(got, want)
    assert int(want[3].sum()) > 0  # detections survive the decode
    assert want[0].shape[0] == BATCH and want[0].shape[2] == (9 if name == "centerpoint" else 7)
    assert f["meta2"] == f["meta"]
    assert f["meta"]["platforms"] == ["cpu"] and f["meta"]["plan_fed"] is False
    assert f["meta"]["model_type"] == type(f["model"]).__name__
    assert set(f["meta"]) == {"model_type", "batch_size", "num_points", "plan_fed", "classes",
                              "platforms", "torch_version", "outputs"}
    assert f["nbytes"] == os.path.getsize(f["path"]) > 1000


@pytest.mark.parametrize("name", ["second", "pointpillars", "centerpoint"])
def test_graph_holds_the_kernels_operators(families, name):
    f = families[name]
    named = list(f["model"].named_modules())
    convs = sum(isinstance(m, SparseConv3d) for _, m in named)
    bns = sum(isinstance(m, MaskedBatchNorm) and not n.startswith("adversary.")
              for n, m in named)
    assert (convs, bns) == OP_NODES[name]
    assert _op_nodes(f["ep"]) == OP_NODES[name]
    # the adversary's five are in the model, not in the clean graph
    assert sum(isinstance(m, MaskedBatchNorm) and n.startswith("adversary.")
               for n, m in named) == 5


def test_plan_fed_artifact_equals_self_contained(families, tmp_path):
    f = families["second"]
    fed = _roundtrip(tmp_path, "second_plan", f["model"], f["anchors"], f["head"], KITTI_POINTS,
                     use_plan=True)
    assert fed["meta2"]["plan_fed"] is True
    assert _op_nodes(fed["ep"]) == OP_NODES["second"]
    pts, msk = f["frames"]
    plan = tvn.plan_to_device(texport.native_plan(f["model"], pts, msk), torch.device("cpu"))
    got = fed["call"](torch.from_numpy(pts), torch.from_numpy(msk), plan)
    _assert_equal(got, f["call"](torch.from_numpy(pts), torch.from_numpy(msk)))
    assert int(got[3].sum()) > 0


def _assert_close_to_jax(got, want):
    gb, gs, gl, gv = (t.numpy() for t in got)
    jb, js, jl, jv = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gv, jv)
    np.testing.assert_array_equal(gl[gv], jl[jv])
    np.testing.assert_allclose(gs[gv], js[jv], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gb[gv], jb[jv], rtol=RTOL, atol=ATOL)
    assert int(jv.sum()) > 0


@pytest.mark.parametrize("name", ["second", "pointpillars", "centerpoint"])
def test_artifact_matches_jax_artifact(families, name):
    f = families[name]
    assert f["meta2"]["model_type"] == f["jmeta"]["model_type"]
    assert f["meta2"]["classes"] == f["jmeta"]["classes"]
    pts, msk = f["frames"]
    got = f["call"](torch.from_numpy(pts), torch.from_numpy(msk))
    _assert_close_to_jax(got, f["jcall"](jnp.asarray(pts), jnp.asarray(msk)))
