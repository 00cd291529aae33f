"""The port's CenterPoint against the JAX package's, on the CPU in float32.

Both sides get the same weights (the JAX model's initial parameters through
tools/convert.centerpoint_to_state_dict), the same native host plan and
run in float32 (compute_dtype, PERT_BF16 pinned off on both sides, TF32
off), on the --tiny smoke grid (25.6 m, 0.4 m voxels, 8 x 8 BEV cells) at
CenterPoint's real widths: the residual encoder's 21 sparse convs, the
512-channel neck, the 6-task head and the (16, 32, 64) adversary. The JAX
encoder's rematerialisation is turned off (RPC_CP_REMAT=0): it does not
change the numerics, only the time.

Tolerances, each measured first:
  * the residual encoder alone (its BEV map and running statistics):
    FWD_RTOL of each tensor's largest entry in eval and train mode
    (measured 9.1e-7 / 2.6e-6);
  * the whole forward's task maps: FWD_RTOL in eval and attack mode
    (measured 3.2e-6 / 2.9e-6), TRAIN_RTOL in train mode (measured 2.8e-5:
    behind the encoder, the dense body's train-mode BatchNorms normalise
    over 128 and 32 BEV cells of the smoke grid, which amplifies float32
    summation order);
  * the plan's layout-independent arrays, the targets' integer fields and
    the decoded detections' masks and labels exactly; the targets'
    heatmaps and rows within 1e-6 (exp, log, sin, cos of two libraries);
  * losses within 1e-6 relative on the same predictions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.cli.train_nuscenes_adversarial import (
    tiny_centerpoint_cfg as jax_tiny_cfg)
from robustpointclouds_tpu.data.nuscenes import synthetic_nuscenes_batch
from robustpointclouds_tpu.models import center_detection as jcd
from robustpointclouds_tpu.models import centerpoint as jcp
from robustpointclouds_tpu.nn.sparse_encoder import SparseEncoder as JEncoder
from robustpointclouds_tpu.ops import sparse as jsparse

from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
from robustpointclouds_tpu_torch.models import center_detection as tcd
from robustpointclouds_tpu_torch.models import centerpoint as tcp
from robustpointclouds_tpu_torch.models.voxelnet import plan_to_device
from robustpointclouds_tpu_torch.nn.sparse_encoder import relation_index
from robustpointclouds_tpu_torch.nn.vfe import HardSimpleVFE
from robustpointclouds_tpu_torch.ops.sparse import SparseGrid
from robustpointclouds_tpu_torch.tools.convert import centerpoint_to_state_dict
from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointPlanBuilder
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

FWD_RTOL = 1e-5
TRAIN_RTOL = 1e-4
TGT_ATOL = 1e-6
LOSS_RTOL = 1e-6


@pytest.fixture(scope="module")
def cp():
    import robustpointclouds_tpu.nn.perturber as jprt
    import robustpointclouds_tpu_torch.nn.perturber as tprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    mp.setenv("RPC_CP_REMAT", "0")
    torch.backends.cudnn.allow_tf32 = False

    jcfg, num_points = jax_tiny_cfg(jcp.CenterPointConfig())
    jcfg = jcfg._replace(compute_dtype="float32")
    tcfg, _ = tiny_centerpoint_cfg(tcp.CenterPointConfig(compute_dtype="float32"))
    pcr = jcfg.voxelizer.point_cloud_range
    batch, vel = synthetic_nuscenes_batch(np.random.RandomState(0), batch_size=2,
                                          num_points=num_points, max_gt=jcfg.head.max_objs,
                                          num_objects=6, point_range=pcr)
    plan = CenterPointPlanBuilder(tcfg)(batch.points, batch.points_mask, batch.gt_boxes,
                                        batch.gt_labels, batch.gt_mask, vel)
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)
    model = jcp.AdversarialCenterPoint(cfg=jcfg)
    pts, msk = jnp.asarray(batch.points), jnp.asarray(batch.points_mask)
    variables = jax.jit(lambda r, pl: model.init(r, pts, msk, True, 0, plan=pl))(
        jax.random.PRNGKey(0), jplan)
    sd = centerpoint_to_state_dict(variables["params"], variables["batch_stats"])
    yield dict(jcfg=jcfg, tcfg=tcfg, batch=batch, vel=vel, plan=plan, jplan=jplan, model=model,
               variables=variables, sd=sd, pts=pts, msk=msk)
    mp.undo()


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def test_the_encoder_has_21_sparse_convs_at_centerpoint_widths(cp):
    net = tcp.AdversarialCenterPoint(cp["tcfg"])
    shapes = [tuple(p.shape) for k, p in net.state_dict().items()
              if k.startswith("pts_middle_encoder") and p.dim() == 5]
    # conv_input + 8 basic blocks x 2 + 3 downs + conv_out
    assert len(shapes) == 21
    got = sorted({(s[4], s[0], s[1] * s[2] * s[3]) for s in shapes})
    assert got == [(5, 16, 27), (16, 16, 27), (16, 32, 27), (32, 32, 27), (32, 64, 27),
                   (64, 64, 27), (64, 128, 27), (128, 128, 3), (128, 128, 27)]
    assert net.load_state_dict(cp["sd"], strict=True)  # every key of the JAX tree maps


def test_plan_matches_jax_build_centerpoint_plan(cp):
    b = cp["batch"]
    ref = jax.jit(lambda p, m, gb, gl, gm, gv: jcp.build_centerpoint_plan(
        p, m, cp["jcfg"], gb, gl, gm, gv))(*(jnp.asarray(x) for x in (
            b.points, b.points_mask, b.gt_boxes, b.gt_labels, b.gt_mask, cp["vel"])))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    got = cp["plan"]
    for k in ("voxels", "vox_coords", "num_points", "voxel_mask", "point_mask", "order",
              "grid_ids", "grid_coords", "grid_mask", "slot_point", "point_slot"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    rk, gk = ref["enc"], got["enc"]
    ids = {0: (got["grid_ids"], ref["grid_ids"])}
    for lvl in (1, 2, 3):
        for k in ("ids", "coords", "mask", "inv"):
            np.testing.assert_array_equal(gk[f"down{lvl}"][k], rk[f"down{lvl}"][k],
                                          err_msg=f"down{lvl}/{k}")
        ids[lvl] = (gk[f"down{lvl}"]["ids"], rk[f"down{lvl}"]["ids"])
    for lvl in range(4):
        # the submanifold relation as the dense index, whatever each side's layout
        g_ids, r_ids = (torch.from_numpy(np.array(x)) for x in ids[lvl])
        tg = relation_index({k: torch.from_numpy(v) for k, v in gk[f"rel{lvl}"].items()}, g_ids)
        tr = relation_index({k: torch.from_numpy(np.array(v)) for k, v in rk[f"rel{lvl}"].items()},
                            r_ids)
        np.testing.assert_array_equal(tg.numpy(), tr.numpy(), err_msg=f"rel{lvl}")
    for k in ("ids", "coords", "mask", "inv", "idx"):
        np.testing.assert_array_equal(gk["out"][k], rk["out"][k], err_msg=f"out/{k}")
    # the targets: the same rows and cells, the same gaussians
    assert len(got["targets"]) == len(ref["targets"]) == 6
    n_pos = 0
    for t, (g, r) in enumerate(zip(got["targets"], ref["targets"])):
        np.testing.assert_array_equal(g["mask"], r["mask"], err_msg=f"task{t}")
        np.testing.assert_array_equal(g["pos"], r["pos"], err_msg=f"task{t}")
        np.testing.assert_allclose(g["anno"], r["anno"], rtol=1e-6, atol=TGT_ATOL)
        np.testing.assert_allclose(g["heatmap"], r["heatmap"], rtol=0, atol=TGT_ATOL)
        np.testing.assert_array_equal(g["heatmap"] == 1.0, r["heatmap"] == 1.0)
        n_pos += int(g["mask"].sum())
    assert n_pos >= 8  # the scenes' objects reach the heatmaps


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_residual_encoder_alone_matches_jax(cp, mode):
    train = mode == "train"
    jcfg, plan, v = cp["jcfg"], cp["plan"], cp["variables"]
    pt = plan_to_device(plan, "cpu")
    feats = HardSimpleVFE(pt["voxels"], pt["point_mask"])
    feats = feats.reshape(-1, feats.shape[-1])[pt["order"].long()]
    b = pt["voxels"].shape[0]
    shape = (b,) + tuple(jcfg.voxelizer.sparse_shape)

    enc = JEncoder(sparse_shape=jcfg.voxelizer.sparse_shape, in_channels=5,
                   encoder_channels=jcfg.encoder_channels, residual=True, dtype=jnp.float32)
    jgrid = jsparse.SparseGrid(cp["jplan"]["grid_ids"], cp["jplan"]["grid_coords"],
                               cp["jplan"]["grid_mask"], shape)
    jvars = {"params": v["params"]["pts_middle_encoder"],
             "batch_stats": v["batch_stats"]["pts_middle_encoder"]}
    jout, jmut = jax.jit(lambda vv, f: enc.apply(vv, f, jgrid, train, plan=cp["jplan"]["enc"],
                                                 mutable=["batch_stats"]))(
        jvars, jnp.asarray(feats.numpy()))

    net = tcp.AdversarialCenterPoint(cp["tcfg"])
    net.load_state_dict(cp["sd"])
    enc_t = net.pts_middle_encoder.train(train)
    with torch.no_grad():
        tout = enc_t(feats, SparseGrid(pt["grid_ids"], pt["grid_coords"], pt["grid_mask"], shape),
                     pt["enc"])
    ref = np.transpose(np.asarray(jout), (0, 3, 1, 2))  # NHWC -> NCHW
    tol = FWD_RTOL
    assert _rel_err(tout.numpy(), ref) <= tol
    assert np.abs(ref).max() > 0
    # running statistics: moved in train mode, untouched in eval
    sd_t = {k[len("pts_middle_encoder."):]: x for k, x in net.state_dict().items()
            if k.startswith("pts_middle_encoder.") and k.endswith(("running_mean", "running_var"))}
    ref_sd = centerpoint_to_state_dict(
        v["params"], {**v["batch_stats"], "pts_middle_encoder": jmut["batch_stats"]})
    for k, x in sd_t.items():
        r = ref_sd[f"pts_middle_encoder.{k}"].numpy()
        np.testing.assert_allclose(x.numpy(), r, rtol=0, atol=tol * max(np.abs(r).max(), 1e-6),
                                   err_msg=k)


def _jax_forward(cp, train, attack, epoch):
    outs, _ = jax.jit(lambda vv, pl: cp["model"].apply(
        vv, cp["pts"], cp["msk"], train, epoch, attack, -1.0, pl, mutable=["batch_stats"]))(
        cp["variables"], cp["jplan"])
    return outs


def _port_forward(cp, train, attack, epoch):
    net = tcp.AdversarialCenterPoint(cp["tcfg"])
    net.load_state_dict(cp["sd"])
    with torch.no_grad():
        return net(None, None, train, epoch, attack, -1.0, plan_to_device(cp["plan"], "cpu"))


@pytest.mark.parametrize("mode", ["eval", "attack", "train"])
def test_forward_matches_jax(cp, mode):
    train, attack, epoch = {"eval": (False, False, 100), "attack": (False, True, 100),
                            "train": (True, False, 5)}[mode]
    jo = _jax_forward(cp, train, attack, epoch)
    to = _port_forward(cp, train, attack, epoch)
    tol = TRAIN_RTOL if train else FWD_RTOL
    assert len(to.task_preds) == 6
    for t, (g, r) in enumerate(zip(to.task_preds, jo.task_preds)):
        assert sorted(g) == sorted(r)
        for k in r:
            assert g[k].dtype == torch.float32 and tuple(g[k].shape) == r[k].shape
            assert _rel_err(g[k].numpy(), r[k]) <= tol, (t, k)
    for k in ("l2_norm", "l2_percentage", "intensity_loss", "bias_loss", "imbalance_loss",
              "max_perturbation"):
        np.testing.assert_allclose(float(to.adv_aux[k]), float(jo.adv_aux[k]), rtol=tol,
                                   atol=1e-7, err_msg=k)
    if train or attack:
        assert float(to.adv_aux["l2_norm"]) > 0  # the adversary ran


@pytest.fixture(scope="module")
def eval_preds(cp):
    """JAX's eval-mode task maps, as numpy, shared by the loss and decode tests."""
    jo = _jax_forward(cp, False, False, 100)
    return [{k: np.asarray(x) for k, x in p.items()} for p in jo.task_preds]


def test_loss_and_adversary_terms_match_jax(cp, eval_preds):
    jpreds = [{k: jnp.asarray(x) for k, x in p.items()} for p in eval_preds]
    tpreds = [{k: torch.from_numpy(x) for k, x in p.items()} for p in eval_preds]
    head = cp["jcfg"].head
    b = cp["batch"]
    jl = jcd.centerpoint_loss(jpreds, *(jnp.asarray(x) for x in (
        b.gt_boxes, b.gt_labels, b.gt_mask, cp["vel"])), head,
        targets=cp["jplan"]["targets"])
    tl = tcd.centerpoint_loss(tpreds, plan_to_device(cp["plan"]["targets"], "cpu"),
                              cp["tcfg"].head)
    assert sorted(tl) == sorted(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=LOSS_RTOL, err_msg=k)
    assert float(tl["loss_heatmap"]) > 0 and float(tl["loss_bbox"]) > 0
    aux = {"l2_norm": 0.0123}
    for epoch in (0, 5, 20):
        jt = jcp.centerpoint_adversary_terms(jl, {k: jnp.float32(x) for k, x in aux.items()},
                                             epoch, 0.05, 0.005)
        tt = tcp.centerpoint_adversary_terms(tl, {k: torch.tensor(x) for k, x in aux.items()},
                                             epoch, 0.05, 0.005)
        np.testing.assert_allclose(float(tt[0]), float(jt[0]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tt[1]), float(jt[1]), rtol=LOSS_RTOL)
        assert sorted(tt[2]) == sorted(jt[2])
        for k in jt[2]:
            np.testing.assert_allclose(float(tt[2][k]), float(jt[2][k]), rtol=LOSS_RTOL,
                                       atol=1e-8, err_msg=k)


@pytest.mark.parametrize("shift", [0.0, 4.0, 6.0])
def test_decode_and_circle_nms_keep_what_jax_keeps(cp, eval_preds, shift):
    """The heatmap logits shifted up so that a random-weight model clears
    the score threshold (0: nothing does; 4 and 6: dozens of candidates,
    circle NMS at work)."""
    preds = [{**p, "heatmap": p["heatmap"] + np.float32(shift)} for p in eval_preds]
    jb, js, jlab, jv = (np.asarray(x) for x in jcd.centerpoint_decode(
        [{k: jnp.asarray(x) for k, x in p.items()} for p in preds], cp["jcfg"].head))
    tb, ts, tlab, tv = (x.numpy() for x in tcd.centerpoint_decode(
        [{k: torch.from_numpy(x) for k, x in p.items()} for p in preds], cp["tcfg"].head))
    assert tb.shape == jb.shape and tb.shape[-1] == 9
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tlab[tv], jlab[jv])
    np.testing.assert_allclose(ts[tv], js[jv], rtol=1e-6)
    np.testing.assert_allclose(tb[tv], jb[jv], rtol=1e-5, atol=1e-5)
    assert tv.any() == bool(shift)  # random weights clear the threshold only when shifted
