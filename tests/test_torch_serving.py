"""The port's serving forward against the JAX AdversarialVoxelNet + anchor_head_predict.

Both sides get the same weights (the JAX model's initialised parameters with
randomised BatchNorm statistics, carried over by the port's weight bridge),
the same native plan and run in float32 (JAX's PERT_BF16 pinned off, the
port's too, compute_dtype float32), on a tiny grid at the real SECOND widths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.cli.common import tiny_voxelnet_cfg
from robustpointclouds_tpu.data import synthetic_kitti_batch
from robustpointclouds_tpu.data.native_plan import build_plan_native
from robustpointclouds_tpu.models import voxelnet as jvn
from robustpointclouds_tpu.models.detection import anchor_head_predict as j_predict
from robustpointclouds_tpu.tools.convert_torch_checkpoint import convert_second_state_dict

from robustpointclouds_tpu_torch.cli.export import export_serving
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.models.detection import (
    AnchorHeadConfig as TAnchorHeadConfig,
    anchor_head_predict as t_predict,
)
from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig as TVoxelizerConfig
from robustpointclouds_tpu_torch.tools.convert import jax_to_state_dict
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

# float32 on both sides; the residual differences are summation order over
# 12 sparse convs, 12 dense convs and the BN chain, measured at ~1e-6
# relative on this setup, so 1e-4 leaves two orders of margin
RTOL, ATOL = 1e-4, 1e-4


def _randomise_bn(tree, rng):
    """Non-trivial BN affine params and running stats, so eval BN is tested."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomise_bn(dict(v), rng)
        elif k in ("scale", "var"):
            out[k] = (0.5 + rng.rand(*np.shape(v))).astype(np.float32)
        elif k in ("bias", "mean") and np.ndim(v) == 1:
            out[k] = (0.1 * rng.randn(*np.shape(v))).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _port_cfg(jcfg):
    vz = jcfg.voxelizer
    return tvn.VoxelNetConfig(
        voxelizer=TVoxelizerConfig(vz.point_cloud_range, vz.voxel_size,
                                   vz.max_points_per_voxel, vz.max_voxels),
        anchor_ranges=jcfg.anchor_ranges, compute_dtype="float32",
    )


@pytest.fixture(scope="module")
def setup():
    import robustpointclouds_tpu.nn.perturber as jprt
    import robustpointclouds_tpu_torch.nn.perturber as tprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    torch.backends.cudnn.allow_tf32 = False

    jcfg = tiny_voxelnet_cfg()._replace(compute_dtype="float32")
    rng = np.random.RandomState(0)
    batch = synthetic_kitti_batch(rng, batch_size=2, num_points=600, max_gt=4,
                                  num_objects=3, point_range=jcfg.voxelizer.point_cloud_range)
    plan = build_plan_native(np.asarray(batch.points), np.asarray(batch.points_mask),
                             jcfg.voxelizer, 4)
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)
    model = jvn.AdversarialVoxelNet(jcfg)
    pts, msk = jnp.asarray(batch.points), jnp.asarray(batch.points_mask)
    variables = model.init(jax.random.PRNGKey(0), pts, msk, True, 0, False, -1.0, jplan)
    params = _randomise_bn(dict(variables["params"]), rng)
    stats = _randomise_bn(dict(variables["batch_stats"]), rng)

    tmodel = tvn.AdversarialVoxelNet(_port_cfg(jcfg))
    tmodel.load_state_dict(jax_to_state_dict(params, stats))
    tmodel.eval()
    yield dict(jcfg=jcfg, plan=plan, jplan=jplan, model=model, params=params,
               stats=stats, pts=pts, msk=msk, tmodel=tmodel)
    mp.undo()


def _jax_forward(s, attack):
    return s["model"].apply({"params": s["params"], "batch_stats": s["stats"]},
                            s["pts"], s["msk"], False, 100, attack, -1.0, s["jplan"])


@pytest.mark.parametrize("attack", [False, True])
def test_model_outputs_match(setup, attack):
    s = setup
    ref = _jax_forward(s, attack)
    with torch.no_grad():
        got = s["tmodel"](None, None, False, 100, attack, -1.0,
                          tvn.plan_to_device(s["plan"], torch.device("cpu")))
    for name in ("cls_scores", "bbox_preds", "dir_preds"):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert r.shape == g.shape, name
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=name)
    assert sorted(ref.adv_aux) == sorted(got.adv_aux)
    for k in ref.adv_aux:
        np.testing.assert_allclose(float(got.adv_aux[k]), float(ref.adv_aux[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
    if attack:
        assert float(ref.adv_aux["l2_norm"]) > 0.0  # the adversary really ran


def test_predict_matches_on_same_head_outputs(setup):
    # the same head outputs through both decoders: sorting, decode and NMS
    # see identical inputs, so detections agree to float32 rounding
    s = setup
    ref = _jax_forward(s, True)
    anchors, _ = s["jcfg"].make_anchors()
    head = s["jcfg"].head
    jb, js, jl, jv = j_predict(ref.cls_scores, ref.bbox_preds, ref.dir_preds,
                               jnp.asarray(anchors), head)
    tb, ts, tl, tv = t_predict(torch.tensor(np.asarray(ref.cls_scores)),
                               torch.tensor(np.asarray(ref.bbox_preds)),
                               torch.tensor(np.asarray(ref.dir_preds)),
                               torch.from_numpy(anchors), TAnchorHeadConfig(*head))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)
    assert int(np.asarray(jv).sum()) > 0  # some detection survives


@pytest.mark.parametrize("attack", [False, True])
def test_serve_matches_jax_serving(setup, attack):
    # end to end through the port's serving entry point on the CPU: valid
    # counts and labels agree exactly, scores to float32 tolerance
    s = setup
    ref = _jax_forward(s, attack)
    anchors, _ = s["jcfg"].make_anchors()
    jb, js, jl, jv = j_predict(ref.cls_scores, ref.bbox_preds, ref.dir_preds,
                               jnp.asarray(anchors), s["jcfg"].head)
    serve = export_serving(s["tmodel"], None, anchors, TAnchorHeadConfig(*s["jcfg"].head),
                           device="cpu")
    tb, ts, tl, tv = serve(None, None, s["plan"], attack=attack)
    assert tb.shape == (2, 50, 7) and ts.shape == (2, 50)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


def test_bridge_roundtrip_through_zoo_converter(setup):
    """convert_second_state_dict(port.state_dict()) gives back the flax
    detector params on every leaf it maps. It maps only conv0 of each SECOND
    backbone stage: its scan of `backbone.blocks.s.j` stops at the first
    parameter-less ReLU index (j=2), which the test pins as a known gap."""
    s = setup
    sd = {k: v.numpy() for k, v in s["tmodel"].state_dict().items()
          if not k.startswith("adversary.")}
    params, stats = convert_second_state_dict(sd)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    ref_p = dict(leaves({k: v for k, v in s["params"].items() if k != "adversary"}))
    ref_s = dict(leaves({k: v for k, v in s["stats"].items() if k != "adversary"}))
    got_p, got_s = dict(leaves(params)), dict(leaves(stats))
    for got, ref in ((got_p, ref_p), (got_s, ref_s)):
        for k, v in got.items():
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
    missing = {k.split("/")[1] for k in set(ref_p) - set(got_p)}
    assert missing == {f"stage{st}_conv{i}" for st in (0, 1) for i in range(1, 6)}
