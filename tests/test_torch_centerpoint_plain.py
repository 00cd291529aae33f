"""The plain-block CenterPoint encoder (`model.residual_encoder=False`) against the JAX package's, on the CPU in float32.

JAX builds it with `residual=False`: the conv_module traversal (conv_input,
stage 0's three submanifold convs 16 -> 16 -> 16 -> 32, each later stage's
strided down first and then its submanifold convs, conv_out) at
CenterPoint's channels ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128,
128)) on the same encoder plan: 13 sparse convs and 13 BNs. Both sides get
the same weights (the JAX trainer's initial parameters through
tools/convert.centerpoint_to_state_dict, which maps `stage{i}_subm{j}` /
`stage{i}_down`), the same native plan and targets, float32 (compute_dtype,
PERT_BF16 pinned off, TF32 off, the JAX encoder's remat off with
RPC_CP_REMAT=0), on the --tiny smoke grid.

Checked, at tests/test_torch_centerpoint.py's and
tests/test_torch_centerpoint_train.py's tolerances: the built config and
the module's 13 convs; the forward's task maps in eval and attack mode
(FWD_RTOL of each map's largest entry); the serve (export_serving, the
plan built inline) against JAX's decode + circle NMS of its eval forward
at score_thr 0; one CenterPointTrainer step at epoch 5 (losses, every
gradient, with the dense body's rounding-level ReLU gates aligned to JAX's
as that file does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.cli.train_nuscenes_adversarial import (
    tiny_centerpoint_cfg as jax_tiny_cfg)
from robustpointclouds_tpu.data.nuscenes import synthetic_nuscenes_batch
from robustpointclouds_tpu.data.structures import PointCloudBatch
from robustpointclouds_tpu.models import center_detection as jcd
from robustpointclouds_tpu.models import centerpoint as jcp
from robustpointclouds_tpu.train import TrainConfig as JTrainConfig
from robustpointclouds_tpu.train.centerpoint_loop import CenterPointTrainer as JTrainer

from robustpointclouds_tpu_torch.cli.export import export_serving
from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
from robustpointclouds_tpu_torch.core.builders import build_centerpoint_config
from robustpointclouds_tpu_torch.core.config import Config
from robustpointclouds_tpu_torch.models import centerpoint as tcp
from robustpointclouds_tpu_torch.models.voxelnet import plan_to_device
from robustpointclouds_tpu_torch.nn.sparse_encoder import SparseConvBlock
from robustpointclouds_tpu_torch.tools.convert import centerpoint_to_state_dict
from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer as TTrainer
from robustpointclouds_tpu_torch.train.loop import TrainConfig as TTrainConfig
from test_torch_centerpoint_train import (BN_BAND, GRAD_FLOOR, GRAD_RTOL, LOSS_RTOL, TRAIN_KW,
                                          _STATS, _jax_dense_bn_outputs, _port_grads)
from test_torch_export import ATOL as SERVE_ATOL, RTOL as SERVE_RTOL, _randomise_jax_bn
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

FWD_RTOL = 1e-5  # tests/test_torch_centerpoint.py's eval / attack forward tolerance
# dense-body ReLU gates the two sides may round to opposite sides of 0 (each
# within BN_BAND of its BN's scale); measured 6 in this step, across the
# backbone and five head branches
MAX_FLIPS = 8
# (Cin, Cout, taps) of the 13 sparse convs, in module order
PLAIN_CONVS = [(5, 16, 27), (16, 16, 27), (16, 16, 27), (16, 32, 27), (32, 32, 27),
               (32, 32, 27), (32, 64, 27), (64, 64, 27), (64, 64, 27), (64, 128, 27),
               (128, 128, 27), (128, 128, 27), (128, 128, 3)]


@pytest.fixture(scope="module")
def cp():
    import robustpointclouds_tpu.nn.perturber as jprt
    import robustpointclouds_tpu_torch.nn.perturber as tprt

    mp = pytest.MonkeyPatch()
    mp.setattr(jprt, "PERT_BF16", False)
    mp.setattr(tprt, "PERT_BF16", False)
    mp.setenv("RPC_CP_REMAT", "0")
    torch.backends.cudnn.allow_tf32 = False

    jcfg, num_points = jax_tiny_cfg(jcp.CenterPointConfig(residual_encoder=False))
    jcfg = jcfg._replace(compute_dtype="float32")
    tcfg, _ = tiny_centerpoint_cfg(tcp.CenterPointConfig(compute_dtype="float32",
                                                         residual_encoder=False))
    raw, vel = synthetic_nuscenes_batch(np.random.RandomState(3), batch_size=2,
                                        num_points=num_points, max_gt=jcfg.head.max_objs,
                                        num_objects=6, point_range=jcfg.voxelizer.point_cloud_range)
    ttr = TTrainer(tcfg, TTrainConfig(**TRAIN_KW), device="cpu")
    plan = ttr.make_plan_builder()(raw.points, raw.points_mask, raw.gt_boxes, raw.gt_labels,
                                   raw.gt_mask, vel)
    batch = PointCloudBatch(*(jnp.asarray(x) for x in raw))
    jtr = JTrainer(model_cfg=jcfg, train_cfg=JTrainConfig(**TRAIN_KW))
    state0 = jtr.init_state(jax.random.PRNGKey(0), batch)
    jplan = jax.tree_util.tree_map(jnp.asarray, plan)
    try:
        yield dict(jcfg=jcfg, tcfg=tcfg, raw=raw, vel=jnp.asarray(vel), batch=batch, plan=plan,
                   jplan=jplan, jtr=jtr, state0=state0, jgrads=jax.jit(jtr._grads), ttr=ttr,
                   sd0=centerpoint_to_state_dict(state0.params, state0.batch_stats))
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jax_eval(cp):
    """On the initial weights with randomised BN statistics and affine maps
    (as tests/test_torch_export.py does: at init the classes of a task tie
    and the decode's labels would follow float32 noise), JAX's eval-mode
    task maps, clean and under attack, and its decode + circle NMS of the
    clean ones at score_thr 0 (one compile)."""
    st = _randomise_jax_bn(cp["state0"], np.random.RandomState(1))
    head = cp["jcfg"].head._replace(score_thr=0.0)

    def fwd(plan):
        variables = {"params": st.params, "batch_stats": st.batch_stats}
        outs = [cp["jtr"].model.apply(variables, cp["batch"].points, cp["batch"].points_mask,
                                      False, 100, attack, -1.0, plan).task_preds
                for attack in (False, True)]
        return outs, jcd.centerpoint_decode(outs[0], head)

    (clean, attacked), dets = jax.jit(fwd)(cp["jplan"])
    return {"eval": clean, "attack": attacked, "dets": dets,
            "sd": centerpoint_to_state_dict(st.params, st.batch_stats)}


def test_plain_encoder_has_13_sparse_convs_and_loads_jaxs_tree(cp):
    cfg = Config({"model": {"type": "CenterPoint", "residual_encoder": False}})
    assert build_centerpoint_config(cfg).residual_encoder is False
    net = tcp.AdversarialCenterPoint(cp["tcfg"])
    enc = net.pts_middle_encoder
    assert not enc.residual
    shapes = [tuple(p.shape) for k, p in net.state_dict().items()
              if k.startswith("pts_middle_encoder") and p.dim() == 5]
    assert [(s[4], s[0], s[1] * s[2] * s[3]) for s in shapes] == PLAIN_CONVS
    n_bn = sum(isinstance(m, SparseConvBlock) for m in enc.modules())
    assert n_bn == 13  # a conv + MaskedBatchNorm pair each
    assert net.load_state_dict(cp["sd0"], strict=True)  # every key of the JAX tree maps


@pytest.mark.parametrize("mode", ["eval", "attack"])
def test_forward_matches_jax(cp, jax_eval, mode):
    net = tcp.AdversarialCenterPoint(cp["tcfg"])
    net.load_state_dict(jax_eval["sd"])
    with torch.no_grad():
        to = net(None, None, False, 100, mode == "attack", -1.0,
                 plan_to_device(cp["plan"], "cpu"))
    jo = jax_eval[mode]
    assert len(to.task_preds) == 6
    for t, (g, r) in enumerate(zip(to.task_preds, jo)):
        assert sorted(g) == sorted(r)
        for k in r:
            ref = np.asarray(r[k], np.float64)
            err = np.abs(g[k].numpy().astype(np.float64) - ref).max()
            assert err <= FWD_RTOL * max(np.abs(ref).max(), 1e-12), (t, k, err)
    if mode == "attack":
        assert float(to.adv_aux["l2_norm"]) > 0  # the adversary ran


def test_serve_matches_jaxs_decode(cp, jax_eval):
    head = cp["tcfg"].head._replace(score_thr=0.0)
    serve = export_serving(tcp.AdversarialCenterPoint(cp["tcfg"]), jax_eval["sd"], None, head,
                           device="cpu")
    tb, ts, tlab, tv = (x.numpy() for x in serve(cp["raw"].points, cp["raw"].points_mask))
    jb, js, jlab, jv = (np.asarray(x) for x in jax_eval["dets"])
    assert tb.shape == jb.shape and tb.shape[-1] == 9 and tv.any()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tlab[tv], jlab[jv])
    # tests/test_torch_export.py's tolerances against JAX's serve
    np.testing.assert_allclose(ts[tv], js[jv], rtol=SERVE_RTOL, atol=SERVE_ATOL)
    np.testing.assert_allclose(tb[tv], jb[jv], rtol=SERVE_RTOL, atol=SERVE_ATOL)


def test_train_step_matches_jax(cp):
    """One step at epoch 5: losses, every gradient (the dense body's
    rounding-level ReLU gates set to JAX's, as tests/test_torch_centerpoint_train.py
    does)."""
    epoch = 5
    (tgrads, tlogs, tnan), bn = _port_grads(cp, epoch)
    ref = _jax_dense_bn_outputs(cp, epoch)
    assert sorted(ref) == sorted(bn)
    flips = {}
    for k, r in ref.items():
        differ = (r > 0) != (bn[k] > 0)
        if differ.any():
            assert float(r[differ].abs().max()) <= BN_BAND * float(r.abs().max()), k
            flips[k] = differ
    assert sum(int(f.sum()) for f in flips.values()) <= MAX_FLIPS, flips.keys()
    if flips:
        (tgrads, tlogs, tnan), _ = _port_grads(cp, epoch, flips)
    grads, aux = cp["jgrads"](cp["state0"], cp["batch"], cp["vel"], jnp.float32(epoch),
                              cp["jplan"])
    jgrads, jlogs, jnan = centerpoint_to_state_dict(grads, cp["state0"].batch_stats), aux[1], aux[2]
    assert not bool(tnan) and not bool(jnan)
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    assert sorted(tgrads) == sorted(k for k in jgrads if not k.endswith(_STATS))
    gmax = max(np.abs(jgrads[k].numpy()).max() for k in tgrads)
    for k, g in tgrads.items():
        ref = jgrads[k].numpy()
        scale = max(np.abs(ref).max(), GRAD_FLOOR * gmax / GRAD_RTOL)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=GRAD_RTOL * scale, err_msg=k)
    enc = [k for k in tgrads if k.startswith("pts_middle_encoder.") and k.endswith(".0.weight")]
    assert len(enc) == 13 and all(float(tgrads[k].abs().sum()) > 0 for k in enc)
    assert float(tlogs["perturbation_l2_norm"]) > 0
