"""The port's masked-statistics VJP against jax.grad of the JAX masked statistics.

On the CPU the port's autograd Function runs `masked_stats_bwd_ref`, the
analytic VJP the card's Triton kernel computes:
    dx = m * (g_mean + 2 * g_var * (x - mean)) / max(cnt, 1).
It must match jax.grad through the Pallas kernel's custom VJP
(robustpointclouds_tpu/kernels/masked_stats.py, interpret mode on the CPU)
and through the two-pass jnp form that the JAX MaskedBatchNorm and the
perturber differentiate, at the shapes of tests/test_kernels.py, with an
all-masked input, with one of the two cotangents missing, and through a
train-mode MaskedBatchNorm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.kernels import masked_stats as jax_masked_stats
from robustpointclouds_tpu.nn import layers as jlayers

from robustpointclouds_tpu_torch.kernels.masked_stats import (
    masked_stats, masked_stats_bwd, masked_stats_bwd_ref)
from robustpointclouds_tpu_torch.nn import layers as tlayers
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

SHAPES = [(100, 8), (1024, 64), (3000, 16)]


def _data(n, c, seed, keep=0.7):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c).astype(np.float32) * 3 + 1
    gm = rng.randn(c).astype(np.float32)
    gv = rng.randn(c).astype(np.float32)
    return x, rng.rand(n) < keep, gm, gv


def _two_pass(x, m):
    mean = jlayers.masked_mean(x, m, keepdims=False)
    var = jlayers.masked_mean((x - mean[None]) ** 2, m, keepdims=False)
    return mean, var


def _port_grad(x, mask, gm, gv):
    xt = torch.from_numpy(x).requires_grad_(True)
    mean, var, cnt = masked_stats(xt, torch.from_numpy(mask))
    assert not cnt.requires_grad
    loss = 0.0
    if gm is not None:
        loss = loss + (mean * torch.from_numpy(gm)).sum()
    if gv is not None:
        loss = loss + (var * torch.from_numpy(gv)).sum()
    loss.backward()
    return xt.grad.numpy()


def _jax_grad(stats_fn, x, mask, gm, gv):
    def loss(a):
        mean, var = stats_fn(a)[:2]
        out = 0.0
        if gm is not None:
            out = out + jnp.sum(mean * gm)
        if gv is not None:
            out = out + jnp.sum(var * gv)
        return out
    return np.asarray(jax.grad(loss)(jnp.asarray(x)))


@pytest.mark.parametrize("n,c", SHAPES)
def test_vjp_matches_pallas_kernel_and_two_pass(n, c):
    x, mask, gm, gv = _data(n, c, seed=n)
    got = _port_grad(x, mask, gm, gv)
    mj = jnp.asarray(mask)
    ref_kernel = _jax_grad(lambda a: jax_masked_stats(a, mj), x, mask, gm, gv)
    ref_jnp = _jax_grad(lambda a: _two_pass(a, mj), x, mask, gm, gv)
    # float32 both ways; the Pallas forward's mean (one pass) feeds its VJP,
    # so against it the (x - mean) term carries that kernel's 1e-5 mean error
    np.testing.assert_allclose(got, ref_kernel, rtol=1e-4, atol=1e-6)
    # autodiff of the two-pass form adds d var/d mean (zero in exact
    # arithmetic) in float32: summation order only
    np.testing.assert_allclose(got, ref_jnp, rtol=1e-4, atol=1e-6)
    assert np.all(got[~mask] == 0.0)  # padding rows get no gradient


@pytest.mark.parametrize("which", ["mean", "var"])
def test_one_cotangent_missing(which):
    x, mask, gm, gv = _data(500, 8, seed=3)
    gm_, gv_ = (gm, None) if which == "mean" else (None, gv)
    got = _port_grad(x, mask, gm_, gv_)
    ref = _jax_grad(lambda a: _two_pass(a, jnp.asarray(mask)), x, mask, gm_, gv_)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    mean, _, cnt = masked_stats(xt, mt)
    direct = masked_stats_bwd(xt, mt, mean, cnt, None if gm_ is None else torch.from_numpy(gm_),
                              None if gv_ is None else torch.from_numpy(gv_))
    np.testing.assert_allclose(direct.numpy(), got, rtol=1e-6, atol=1e-7)


def test_all_masked_gives_zero_gradient():
    x, _, gm, gv = _data(64, 4, seed=5)
    mask = np.zeros(64, bool)
    got = _port_grad(x, mask, gm, gv)
    ref = _jax_grad(lambda a: jax_masked_stats(a, jnp.asarray(mask)), x, mask, gm, gv)
    np.testing.assert_array_equal(got, np.zeros_like(x))
    np.testing.assert_array_equal(ref, np.zeros_like(x))


def test_bf16_input_gives_bf16_gradient():
    x, mask, gm, gv = _data(256, 16, seed=6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    mean, _, cnt = masked_stats(xb, torch.from_numpy(mask))
    dx = masked_stats_bwd_ref(xb, torch.from_numpy(mask), mean, cnt, torch.from_numpy(gm),
                              torch.from_numpy(gv))
    assert dx.dtype == torch.bfloat16
    ref = _jax_grad(lambda a: _two_pass(a, jnp.asarray(mask)), np.asarray(xb.float()), mask, gm, gv)
    # one bf16 rounding of dx (2^-8 relative)
    np.testing.assert_allclose(dx.float().numpy(), ref, rtol=1e-2, atol=1e-4)


def test_masked_batchnorm_train_grads_match_flax():
    x, mask, _, _ = _data(500, 16, seed=7)
    rng = np.random.RandomState(8)
    scale = (0.5 + rng.rand(16)).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    g_out = rng.randn(500, 16).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(16, np.float32), "var": np.ones(16, np.float32)}}

    def loss(a, p):
        y, _ = jlayers.MaskedBatchNorm().apply({"params": p, "batch_stats": variables["batch_stats"]},
                                               a, jnp.asarray(mask), True, mutable=["batch_stats"])
        return jnp.sum(y * g_out)
    jx, jp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), variables["params"])

    bn = tlayers.MaskedBatchNorm(16)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    (bn(xt, torch.from_numpy(mask)) * torch.from_numpy(g_out)).sum().backward()
    # float32 both sides; summation order through the batch statistics
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(jp["scale"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(jp["bias"]), rtol=1e-4, atol=1e-4)
