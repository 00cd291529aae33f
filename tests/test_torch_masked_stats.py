"""The port's masked statistics (plain version) and MaskedBatchNorm vs the JAX package.

The port's plain version computes the two-pass form of nn/layers.masked_mean
(the form the card's kernel is held against); the Pallas kernel (interpret
mode here) computes var as E[x^2] - mean^2, so against it the tolerance is
that kernel's own test's, and against the two-pass JAX form it is float32
summation order only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.kernels import masked_stats as jax_masked_stats
from robustpointclouds_tpu.nn import layers as jlayers

from robustpointclouds_tpu_torch.kernels.masked_stats import masked_stats, masked_stats_ref
from robustpointclouds_tpu_torch.nn import layers as tlayers
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

SHAPES = [(100, 8), (1024, 64), (3000, 16), (4800, 4)]


def _data(n, c, seed=0, keep=0.7):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c).astype(np.float32) * 3 + 1
    return x, rng.rand(n) < keep


@pytest.mark.parametrize("n,c", SHAPES)
def test_ref_matches_pallas_kernel(n, c):
    x, mask = _data(n, c)
    mean, var, cnt = masked_stats_ref(torch.from_numpy(x), torch.from_numpy(mask))
    jm, jv, jc = jax_masked_stats(jnp.asarray(x), jnp.asarray(mask))
    # the tests/test_kernels.py tolerances: the Pallas var cancels in E[x^2]-mean^2
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(jv), rtol=1e-3, atol=1e-4)
    assert float(cnt) == float(jc) == mask.sum()


@pytest.mark.parametrize("n,c", SHAPES)
def test_ref_matches_two_pass_masked_mean(n, c):
    x, mask = _data(n, c, seed=1)
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    jm = jlayers.masked_mean(xj, mj, keepdims=False)
    jv = jlayers.masked_mean((xj - jm[None]) ** 2, mj, keepdims=False)
    mean, var, _ = masked_stats_ref(torch.from_numpy(x), torch.from_numpy(mask))
    # same two-pass arithmetic in float32; summation order only
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tlayers.masked_mean(torch.from_numpy(x), torch.from_numpy(mask)).numpy(),
                               np.asarray(jm), rtol=1e-5, atol=1e-6)


def test_all_masked():
    x = np.ones((64, 4), np.float32)
    mask = np.zeros(64, bool)
    mean, var, cnt = masked_stats(torch.from_numpy(x), torch.from_numpy(mask))
    jm, jv, jc = jax_masked_stats(jnp.asarray(x), jnp.asarray(mask))
    assert float(cnt) == float(jc) == 0.0
    np.testing.assert_array_equal(mean.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(var.numpy(), np.zeros(4, np.float32))


@pytest.mark.parametrize("train", [True, False])
def test_masked_batchnorm_matches_flax(train):
    x, mask = _data(500, 16, seed=2)
    rng = np.random.RandomState(3)
    scale = (0.5 + rng.rand(16)).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    ra_mean = rng.randn(16).astype(np.float32)
    ra_var = (0.5 + rng.rand(16)).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}
    y, upd = jlayers.MaskedBatchNorm().apply(
        variables, jnp.asarray(x), jnp.asarray(mask), train, mutable=["batch_stats"])

    bn = tlayers.MaskedBatchNorm(16)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(ra_mean),
                        "running_var": torch.from_numpy(ra_var),
                        "num_batches_tracked": torch.tensor(0)})
    bn.train(train)
    with torch.no_grad():
        got = bn(torch.from_numpy(x), torch.from_numpy(mask))
    # float32 both sides; batch statistics in another summation order
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)

