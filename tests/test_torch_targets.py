"""The port's training targets, losses, optimizer schedule and NaN ladder against the JAX package.

Box encoding and the nearest-BEV IoU match in float32; the Max-IoU
assignment (ops/assigner) and its plan group (anchor_assign_plan) are
bit-equal on a case with argmax ties, forced positives, two GTs that force
the same anchor and masked GTs. Each loss, the anchor_head_loss dict,
adversary_direct_terms, device_nan_ladder and the learning-rate schedule
match their JAX counterparts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.cli.common import tiny_voxelnet_cfg
from robustpointclouds_tpu.models import detection as jdet
from robustpointclouds_tpu.models import voxelnet as jvn
from robustpointclouds_tpu.ops import assigner as jassigner, box_coder as jbc, boxes as jboxes
from robustpointclouds_tpu.ops import losses as jlosses
from robustpointclouds_tpu.train import hooks as jhooks
from robustpointclouds_tpu.train.loop import TrainConfig as JTrainConfig, make_lr_schedule as j_sched

from robustpointclouds_tpu_torch.models import detection as tdet
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.ops import assigner as tassigner, box_coder as tbc, boxes as tboxes
from robustpointclouds_tpu_torch.ops import losses as tlosses
from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig as TVoxelizerConfig
from robustpointclouds_tpu_torch.train import hooks as thooks
from robustpointclouds_tpu_torch.train.loop import TrainConfig as TTrainConfig, make_lr_schedule as t_sched
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

HEAD = jdet.AnchorHeadConfig()
# float32 elementwise math on both sides (transcendentals may differ by an ulp)
F32 = dict(rtol=1e-6, atol=1e-6)


def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = rng.uniform(0, 16, n)
    b[:, 1] = rng.uniform(-8, 8, n)
    b[:, 2] = rng.uniform(-1, 0, n)
    b[:, 3:6] = rng.uniform(0.5, 4, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_encode_matches():
    rng = np.random.RandomState(0)
    boxes, anchors = _boxes(rng, 300), _boxes(rng, 300)
    ref = np.asarray(jbc.encode(jnp.asarray(boxes), jnp.asarray(anchors)))
    got = tbc.encode(torch.from_numpy(boxes), torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, ref, **F32)
    back = tbc.decode(torch.from_numpy(got), torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(back, boxes, rtol=1e-5, atol=1e-5)


def test_nearest_bev_iou_is_bit_equal():
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 200), _boxes(rng, 30)
    a[:20, 6] = np.pi / 4  # on the snap boundary
    ref = np.asarray(jboxes.nearest_bev_iou(jnp.asarray(a), jnp.asarray(b)))
    got = tboxes.nearest_bev_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tboxes.nearest_bev_boxes(torch.from_numpy(a)).numpy(),
        np.asarray(jboxes.nearest_bev_boxes(jnp.asarray(a))))


def _tie_case():
    """Anchors of the tiny config vs GTs built to tie, force and collide."""
    cfg = tiny_voxelnet_cfg()
    anchors, cls = cfg.make_anchors()
    g = np.zeros((2, 8, 7), np.float32)
    labels = np.zeros((2, 8), np.int32)
    mask = np.zeros((2, 8), bool)
    # sample 0: two identical Car GTs (both force the same anchor), a Car GT
    # exactly on an anchor, a small pedestrian GT that only a forced
    # positive represents, and a masked GT on top of the first
    car = anchors[(cls == 0)][20].copy()
    g[0, 0] = g[0, 1] = car + np.array([0.3, 0.2, 0, 0, 0, 0, 0], np.float32)
    g[0, 2] = anchors[(cls == 0)][7]
    ped = anchors[(cls == 1)][13].copy()
    g[0, 3] = ped + np.array([0.3, -0.15, 0, 0.1, 0, 0, 0.4], np.float32)
    g[0, 4] = g[0, 0]
    labels[0, :5] = [0, 0, 0, 1, 0]
    mask[0, :4] = True
    # sample 1: two cyclist GTs whose best anchor is the same one: argmax
    # picks GT 0 (higher IoU), the forced scatter-max the larger index, GT 1;
    # and a GT off the grid
    cyc = anchors[(cls == 2)][21].copy()
    g[1, 0] = cyc + np.array([0.1, 0.05, 0, 0, 0, 0, 0], np.float32)
    g[1, 1] = cyc + np.array([0.2, 0.1, 0, 0, 0, 0, 0], np.float32)
    g[1, 2] = np.array([30, 30, -1, 2, 2, 2, 0], np.float32)
    labels[1, :3] = [2, 2, 0]
    mask[1, :3] = True
    return cfg, anchors, cls, g, labels, mask


def test_assign_is_bit_equal_with_ties_and_forced_positives():
    cfg, anchors, cls, g, labels, mask = _tie_case()
    t = tassigner.assign(torch.from_numpy(anchors), torch.from_numpy(cls), torch.from_numpy(g),
                         torch.from_numpy(labels), torch.from_numpy(mask),
                         HEAD.pos_iou_thr, HEAD.neg_iou_thr, HEAD.min_pos_iou)
    for b in range(2):
        # eager JAX: the same float32 operations in the same order
        j = jassigner.assign(jnp.asarray(anchors), jnp.asarray(cls), jnp.asarray(g[b]),
                             jnp.asarray(labels[b]), jnp.asarray(mask[b]),
                             HEAD.pos_iou_thr, HEAD.neg_iou_thr, HEAD.min_pos_iou)
        for name in ("labels", "matched_gt", "max_iou", "pos_mask", "neg_mask"):
            np.testing.assert_array_equal(getattr(t, name)[b].numpy(), np.asarray(getattr(j, name)),
                                          err_msg=f"{name} sample {b}")
    # the case does exercise what it is named for
    pos = t.pos_mask.numpy()
    assert (t.labels.numpy()[0][pos[0]] == 1).any()       # the forced pedestrian
    assert 1 in t.matched_gt.numpy()[0][pos[0]]           # identical GTs: the larger index
    assert 1 in t.matched_gt.numpy()[1][pos[1]]           # the collision went to GT 1
    # anchors with no same-class GT tie at IoU -1 across every GT: argmax -> 0
    none = t.max_iou.numpy() == -1.0
    assert none.any() and (t.matched_gt.numpy()[none] == 0).all()


def test_anchor_assign_plan_is_bit_equal():
    cfg, _, _, g, labels, mask = _tie_case()
    ref = jvn.anchor_assign_plan(jnp.asarray(g), jnp.asarray(labels), jnp.asarray(mask), cfg)
    vz = cfg.voxelizer
    tcfg = tvn.VoxelNetConfig(voxelizer=TVoxelizerConfig(vz.point_cloud_range, vz.voxel_size,
                                                          vz.max_points_per_voxel, vz.max_voxels),
                              anchor_ranges=cfg.anchor_ranges)
    got = tvn.anchor_assign_plan(g, labels, mask, tcfg)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    # the JAX plan builder jits it, and XLA's fused IoU can differ by an ulp
    # (this case has such an anchor, a negative one whose two GT IoUs tie in
    # eager float32): the targets that reach the loss still agree exactly
    jit = jax.jit(lambda gb, gl, gm: jvn.anchor_assign_plan(gb, gl, gm, cfg))(
        jnp.asarray(g), jnp.asarray(labels), jnp.asarray(mask))
    for k in ("labels", "pos_mask", "neg_mask"):
        np.testing.assert_array_equal(got[k], np.asarray(jit[k]), err_msg=k)
    pos = got["pos_mask"]
    np.testing.assert_array_equal(got["matched_gt"][pos], np.asarray(jit["matched_gt"])[pos])


def test_each_loss_matches():
    rng = np.random.RandomState(2)
    logits = rng.randn(4, 50, 3).astype(np.float32) * 3
    onehot = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (4, 50))][..., :3]
    w = (rng.rand(4, 50) > 0.3).astype(np.float32)
    pred, tgt = rng.randn(4, 50, 7).astype(np.float32), rng.randn(4, 50, 7).astype(np.float32)
    dlog, dlab = rng.randn(4, 50, 2).astype(np.float32), rng.randint(0, 2, (4, 50))
    T, J = torch.from_numpy, jnp.asarray
    pairs = [
        (tlosses.sigmoid_focal_loss(T(logits), T(onehot), T(w), 2.0, 0.25, avg_factor=torch.tensor(7.0)),
         jlosses.sigmoid_focal_loss(J(logits), J(onehot), J(w), 2.0, 0.25, avg_factor=7.0)),
        (tlosses.smooth_l1_loss(T(pred), T(tgt), T(w), 1 / 9, avg_factor=3.0),
         jlosses.smooth_l1_loss(J(pred), J(tgt), J(w), 1 / 9, avg_factor=3.0)),
        (tlosses.cross_entropy_loss(T(dlog), T(dlab), T(w), avg_factor=0.5),
         jlosses.cross_entropy_loss(J(dlog), J(dlab), J(w), avg_factor=0.5)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    for a, b in zip(tlosses.add_sin_difference(T(pred[..., 6]), T(tgt[..., 6])),
                    jlosses.add_sin_difference(J(pred[..., 6]), J(tgt[..., 6]))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_anchor_head_loss_dict_and_gradients_match():
    cfg, anchors, cls, g, labels, mask = _tie_case()
    ny, nx = cfg.bev_feature_size
    rng = np.random.RandomState(3)
    c = rng.randn(2, ny, nx, 6, 3).astype(np.float32)
    b = rng.randn(2, ny, nx, 6, 7).astype(np.float32) * 0.3
    d = rng.randn(2, ny, nx, 6, 2).astype(np.float32)

    def jloss(c_, b_, d_, assign):
        out = jdet.anchor_head_loss(c_, b_, d_, jnp.asarray(anchors), jnp.asarray(cls), jnp.asarray(g),
                                    jnp.asarray(labels), jnp.asarray(mask), HEAD, assign=assign)
        return out["loss_cls"] + out["loss_bbox"] + out["loss_dir"], out

    jassign = jvn.anchor_assign_plan(jnp.asarray(g), jnp.asarray(labels), jnp.asarray(mask), cfg)
    for assign in (None, jassign):
        (_, ref), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(c), jnp.asarray(b), jnp.asarray(d), assign)
        tens = [torch.from_numpy(x).requires_grad_(True) for x in (c, b, d)]
        tassign = None if assign is None else {k: torch.from_numpy(np.asarray(v)) for k, v in assign.items()}
        got = tdet.anchor_head_loss(*tens, torch.from_numpy(anchors), torch.from_numpy(cls),
                                    torch.from_numpy(g), torch.from_numpy(labels),
                                    torch.from_numpy(mask), tdet.AnchorHeadConfig(*HEAD), assign=tassign)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)
        assert float(ref["num_pos"]) >= 3
        (got["loss_cls"] + got["loss_bbox"] + got["loss_dir"]).backward()
        for t, r in zip(tens, jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("epoch,l2", [(0, 0.0004), (5, 0.003), (12, 0.008), (40, 0.05)])
def test_adversary_direct_terms_match(epoch, l2):
    rng = np.random.RandomState(epoch)
    aux = {k: np.float32(v) for k, v in zip(
        ("l2_norm", "l2_percentage", "intensity_loss", "bias_loss", "imbalance_loss",
         "max_perturbation", "mean_perturbation", "std_perturbation"),
        [l2] + list(rng.rand(7) * 0.1))}
    det = {"loss_cls": np.float32(1.3), "loss_bbox": np.float32(150.0), "loss_dir": np.float32(np.nan),
           "num_pos": np.float32(4)}
    rt, rl = jvn.adversary_direct_terms({k: jnp.asarray(v) for k, v in det.items()},
                                        {k: jnp.asarray(v) for k, v in aux.items()}, epoch)
    taux = {k: torch.tensor(v, requires_grad=True) for k, v in aux.items()}
    gt, gl = tvn.adversary_direct_terms({k: torch.tensor(v) for k, v in det.items()}, taux, epoch)
    np.testing.assert_allclose(float(gt), float(rt), rtol=1e-6)
    assert sorted(gl) == sorted(rl)
    for k in rl:
        np.testing.assert_allclose(float(gl[k]), float(rl[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    # gradients: l2's weak factor is detached on both sides
    jgrad = jax.grad(lambda a: jvn.adversary_direct_terms(
        {k: jnp.asarray(v) for k, v in det.items()}, a, epoch)[0])(
        {k: jnp.asarray(v) for k, v in aux.items()})
    gt.backward()
    for k in ("l2_norm", "intensity_loss", "bias_loss", "imbalance_loss"):
        np.testing.assert_allclose(float(taux[k].grad), float(jgrad[k]), rtol=1e-6, err_msg=k)


def test_device_nan_ladder_matches():
    lr, en = 1.0, 1.0
    for total, step in [(0, 1), (9, 1), (9, 0), (10, 1), (100, 1), (101, 0), (5, 0)]:
        j = jhooks.device_nan_ladder(jnp.int32(total), jnp.int32(step), jnp.float32(lr), jnp.float32(en))
        t = thooks.device_nan_ladder(torch.tensor(total, dtype=torch.int32),
                                     torch.tensor(step, dtype=torch.int32),
                                     torch.tensor(lr), torch.tensor(en))
        for a, b in zip(t, j):
            assert float(a) == float(b), (total, step)


def test_lr_schedule_matches_optax():
    kw = dict(warmup_iters=20, max_epochs=3, steps_per_epoch=30)
    js, ts = j_sched(JTrainConfig(**kw)), t_sched(TTrainConfig(**kw))
    for count in [0, 1, 10, 19, 20, 21, 50, 89, 90, 200]:
        # optax evaluates the schedule in float32, the port in float64
        np.testing.assert_allclose(ts(count), float(js(count)), rtol=1e-5)
    assert ts(0) == pytest.approx(1e-5)  # step 0 runs at the warm-up's first value
