"""The port's geometry, decoding and adversary modules vs the JAX package, in float32.

Modules on the serving path that hold no kernel: rotated BEV IoU and NMS,
the box decoder, the VoxelPerturber (here also in train mode, where its
MaskedBatchNorms take batch statistics) and the gradient-reversal op.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.nn import perturber as jprt
from robustpointclouds_tpu.ops import box_coder as jcoder, boxes as jboxes, nms as jnms

from robustpointclouds_tpu_torch.nn import perturber as tprt
from robustpointclouds_tpu_torch.ops import box_coder as tcoder, boxes as tboxes, nms as tnms
from robustpointclouds_tpu_torch.ops.grad import grad_scale
from robustpointclouds_tpu_torch.tools.convert import perturber_to_state_dict
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)


def _bev(rng, n, spread=6.0):
    b = np.stack([rng.uniform(-spread, spread, n), rng.uniform(-spread, spread, n),
                  rng.uniform(0.5, 4.0, n), rng.uniform(0.5, 2.0, n),
                  rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    b[:2, 2:4] = 0.0  # degenerate rows get IoU 0
    return b


def test_rotated_bev_iou_matches():
    rng = np.random.RandomState(0)
    a, b = _bev(rng, 20), _bev(rng, 15)
    ref = np.asarray(jboxes.rotated_bev_iou(jnp.asarray(a), jnp.asarray(b)))
    got = tboxes.rotated_bev_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    # float32 polygon clipping on both sides; areas are O(1-10) m^2
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (ref > 0).sum() > 10


def test_rotated_nms_batched_matches_per_row():
    # one sweep over [rows, N] equals the JAX per-row sweep. Thresholds sit
    # halfway across the widest gaps between the IoU values, so a float32
    # rounding difference in an IoU cannot flip a decision at the threshold
    rng = np.random.RandomState(1)
    bev = np.stack([_bev(rng, 40, spread=3.0) for _ in range(3)])
    valid = rng.rand(3, 40) > 0.2
    iou = np.stack([np.asarray(jboxes.rotated_bev_iou(jnp.asarray(b), jnp.asarray(b))) for b in bev])
    vals = np.unique(iou[(iou > 0.0) & (iou < 0.99)])
    widest = np.argsort(np.diff(vals))[::-1][:3]
    assert np.diff(vals)[widest].min() > 2e-3
    for thr in (vals[widest] + vals[widest + 1]) / 2:
        got = tnms.rotated_nms(torch.from_numpy(bev), None, torch.from_numpy(valid), thr).numpy()
        for r in range(3):
            ref = jnms.rotated_nms(jnp.asarray(bev[r]), None, jnp.asarray(valid[r]), thr)
            np.testing.assert_array_equal(got[r], np.asarray(ref))
        assert 0 < got.sum() < valid.sum()  # something kept, something suppressed


def test_decode_and_limit_period_match():
    rng = np.random.RandomState(2)
    deltas = (rng.randn(50, 7) * 0.5).astype(np.float32)
    anchors = np.abs(rng.randn(50, 7)).astype(np.float32) + 0.5
    np.testing.assert_allclose(
        tcoder.decode(torch.from_numpy(deltas), torch.from_numpy(anchors)).numpy(),
        np.asarray(jcoder.decode(jnp.asarray(deltas), jnp.asarray(anchors))), rtol=1e-6, atol=1e-6)
    yaw = (rng.randn(50) * 5).astype(np.float32)
    np.testing.assert_allclose(tboxes.limit_period(torch.from_numpy(yaw), 0.0, np.pi).numpy(),
                               np.asarray(jboxes.limit_period(jnp.asarray(yaw), 0.0, np.pi)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("train,attack", [(True, False), (False, True)])
def test_perturber_matches(monkeypatch, train, attack):
    monkeypatch.setattr(jprt, "PERT_BF16", False)
    monkeypatch.setattr(tprt, "PERT_BF16", False)
    rng = np.random.RandomState(3)
    feats = (rng.randn(300, 4) * [10.0, 10.0, 1.0, 0.3]).astype(np.float32)
    mask = rng.rand(300) > 0.4
    hidden = (8, 16, 8)
    jmod = jprt.VoxelPerturber(num_features=4, hidden_channels=hidden)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(mask), True)
    (jout, jaux), upd = jmod.apply(variables, jnp.asarray(feats), jnp.asarray(mask), train,
                                   attack, mutable=["batch_stats"])

    tmod = tprt.VoxelPerturber(num_features=4, hidden_channels=hidden)
    tmod.load_state_dict(perturber_to_state_dict(variables["params"], variables["batch_stats"]))
    tmod.train(train)
    with torch.no_grad():
        tout, taux = tmod(torch.from_numpy(feats), torch.from_numpy(mask), attack)
    # float32 both sides; batch statistics and matmuls in another order
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    if train:  # running statistics updated as flax does
        for i in range(5):
            np.testing.assert_allclose(getattr(tmod, f"bn_{i}").running_var.numpy(),
                                       np.asarray(upd["batch_stats"][f"bn_{i}"]["var"]),
                                       rtol=1e-5, atol=1e-6)


def test_grad_scale_reverses_gradient_only():
    x = torch.randn(5, 3, requires_grad=True)
    y = grad_scale(x, -0.5)
    torch.testing.assert_close(y, x)
    y.sum().backward()
    torch.testing.assert_close(x.grad, torch.full_like(x, -0.5))
