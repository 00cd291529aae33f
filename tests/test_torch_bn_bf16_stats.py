"""K2's bfloat16-read mode (RPC_BN_BF16_STATS) on the CPU: the port's
MaskedBatchNorm with `nn/layers.BN_BF16_STATS` set, on bfloat16 input,
against the JAX package's MaskedBatchNorm with its BN_BF16_STATS set (the
lowp path, robustpointclouds_tpu/nn/layers.py:68-94), followed as in the
sparse encoder by ReLU and the row mask where asked.

Held (measured on these inputs in brackets):
  * y within one bfloat16 rounding step, rtol 2**-7, and bit-equal on all
    but Y_MISMATCH of its entries (all), where the port's float32-read y
    on the same inputs differs from JAX's on at least Y_DIFFERS of them
    (13-43%), so the check fails a port that ignores the mode;
  * the running statistics within rtol 1e-5, atol 1e-6 (1.2e-7);
  * dx within 1e-2 of its largest entry (5.8e-3) and d gamma, d beta within
    5e-2 of theirs (2.8e-2): the port's backward is the analytic float32
    one on the lowp statistics, with the ReLU gate on the lowp y; JAX's is
    its autodiff through bfloat16 ops, which rounds the cotangents and
    sums d beta over the rows in bfloat16.
The mode leaves float32 input alone, and the apply operator still takes a
call that does not name `lowp` (an artifact exported before the mode).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustpointclouds_tpu.nn.layers as jlayers

from robustpointclouds_tpu_torch.kernels import masked_stats as ms
from robustpointclouds_tpu_torch.nn import layers as tlayers

import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

Y_RTOL = 2.0 ** -7
Y_MISMATCH = 1e-3
Y_DIFFERS = 2e-2
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
DX_TOL = 1e-2
PARAM_TOL = 5e-2
N = 3000


def _inputs(c, seed):
    rng = np.random.RandomState(seed)
    x = jnp.asarray((rng.randn(N, c) * 2 + 0.7).astype(np.float32)).astype(jnp.bfloat16)
    mask = rng.rand(N) < 0.8
    scale = (1 + 0.3 * rng.randn(c)).astype(np.float32)
    bias = (0.2 * rng.randn(c)).astype(np.float32)
    rm = (0.1 * rng.randn(c)).astype(np.float32)
    rv = (1 + 0.2 * rng.rand(c)).astype(np.float32)
    g = rng.randn(N, c).astype(np.float32)
    return x, mask, scale, bias, rm, rv, g


def _jax(x, mask, scale, bias, rm, rv, g, train, relu, monkeypatch):
    import jax

    monkeypatch.setattr(jlayers, "BN_BF16_STATS", True)
    mod = jlayers.MaskedBatchNorm(dtype=jnp.bfloat16)
    stats = {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}
    m = jnp.asarray(mask)

    def fwd(params, xx):
        y, upd = mod.apply({"params": params, "batch_stats": stats}, xx, m, train,
                           mutable=["batch_stats"])
        if relu:
            y = jnp.where(m[:, None], jax.nn.relu(y), 0)
        return y, upd["batch_stats"]

    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    y, new_stats = fwd(params, x)
    loss = lambda p, xx: jnp.sum(fwd(p, xx)[0].astype(jnp.float32) * jnp.asarray(g))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    f = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return f(y), f(new_stats["mean"]), f(new_stats["var"]), f(gx), f(gp["scale"]), f(gp["bias"])


def _port(x, mask, scale, bias, rm, rv, g, train, relu, monkeypatch, lowp=True):
    monkeypatch.setattr(tlayers, "BN_BF16_STATS", lowp)
    c = scale.shape[0]
    bn = tlayers.MaskedBatchNorm(c, dtype=torch.bfloat16)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(rm))
        bn.running_var.copy_(torch.from_numpy(rv))
    bn.train(train)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    xt.requires_grad_(True)
    y = bn(xt, torch.from_numpy(mask), relu=relu, row_mask=relu)
    (y.float() * torch.from_numpy(g)).sum().backward()
    return (y.detach().float().numpy(), bn.running_mean.numpy(), bn.running_var.numpy(),
            xt.grad.float().numpy(), bn.weight.grad.numpy(), bn.bias.grad.numpy())


def _close_to_max(got, ref, tol, name):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("c", [4, 16, 64])
def test_lowp_batch_norm_matches_jax(c, train, relu, monkeypatch):
    inputs = _inputs(c, seed=c)
    y, rm, rv, gx, gw, gb = _port(*inputs, train, relu, monkeypatch)
    jy, jrm, jrv, jgx, jgw, jgb = _jax(*inputs, train, relu, monkeypatch)
    np.testing.assert_allclose(y, jy, rtol=Y_RTOL, atol=0)
    assert np.mean(y != jy) <= Y_MISMATCH
    f32_read = _port(*inputs, train, relu, monkeypatch, lowp=False)[0]
    assert np.mean(f32_read != jy) >= Y_DIFFERS
    np.testing.assert_allclose(rm, jrm, **STATS_TOL)
    np.testing.assert_allclose(rv, jrv, **STATS_TOL)
    _close_to_max(gx, jgx, DX_TOL, "dx")
    _close_to_max(gw, jgw, PARAM_TOL, "d gamma")
    _close_to_max(gb, jgb, PARAM_TOL, "d beta")
    if relu:
        assert (y == 0).any() and (y > 0).any()


def test_plain_statistics_round_as_jax():
    """masked_stats_lowp_ref: the mean summed in float32 over bfloat16 reads,
    the variance of the bfloat16 deviations from the bfloat16 mean."""
    x, mask, *_ = _inputs(16, seed=5)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    mean, var, cnt = ms.masked_stats_lowp_ref(xt, torch.from_numpy(mask))
    xv = np.asarray(x.astype(jnp.float32))[mask].astype(np.float64)
    np.testing.assert_allclose(mean.numpy(), xv.mean(0), rtol=1e-5, atol=1e-6)
    mb = torch.from_numpy(mean.numpy()).to(torch.bfloat16).float().numpy().astype(np.float64)
    d = torch.from_numpy((xv - mb).astype(np.float32)).to(torch.bfloat16).float().numpy()
    dd = torch.from_numpy(d * d).to(torch.bfloat16).float().numpy().astype(np.float64)
    np.testing.assert_allclose(var.numpy(), dd.mean(0), rtol=1e-5, atol=1e-6)
    assert float(cnt) == mask.sum()
    # the rounding shows: float32 reads give another variance
    ref_var = ms.masked_stats_ref(xt, torch.from_numpy(mask))[1]
    assert not torch.equal(var, ref_var)


def test_mode_leaves_float32_input_and_needs_bfloat16(monkeypatch):
    x, mask, scale, bias, rm, rv, _ = _inputs(16, seed=3)
    xf = torch.from_numpy(np.asarray(x.astype(jnp.float32)))
    outs = []
    for on in (False, True):
        monkeypatch.setattr(tlayers, "BN_BF16_STATS", on)
        bn = tlayers.MaskedBatchNorm(16)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            outs.append((bn(xf, torch.from_numpy(mask), relu=True), bn.running_var.clone()))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    w, b = torch.from_numpy(scale), torch.from_numpy(bias)
    with pytest.raises(ValueError, match="bfloat16-read mode takes bfloat16"):
        ms.masked_batch_norm(xf, torch.from_numpy(mask), w, b, torch.from_numpy(rm),
                             torch.from_numpy(rv), True, lowp=True)


def test_apply_operator_without_lowp_is_the_float32_read_apply():
    x, mask, scale, bias, rm, rv, _ = _inputs(8, seed=4)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    args = (xt, torch.from_numpy(mask), torch.from_numpy(rm), torch.from_numpy(rv),
            torch.from_numpy(scale), torch.from_numpy(bias), 1e-3, True, True, torch.bfloat16)
    old = torch.ops.rpc.masked_bn_apply.default(*args)  # as a pre-mode artifact's node calls it
    assert torch.equal(old, ms.bn_apply_ref(*args))
    lowp = torch.ops.rpc.masked_bn_apply.default(*args, True)
    assert torch.equal(lowp, ms.bn_apply_ref(*args, lowp=True))
    assert not torch.equal(old, lowp)
