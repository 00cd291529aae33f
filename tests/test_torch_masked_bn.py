"""The port's fused MaskedBatchNorm (+ ReLU, + row mask) against the flax MaskedBatchNorm.

On the CPU `MaskedBatchNormFunction` runs the plain versions: the forward
`masked_batch_norm_ref` (the eager composition the kernels replace) and the
analytic backward `masked_batch_norm_bwd_ref` that the card's `bwd_reduce` and
`dx` kernels compute. Both are held here against
robustpointclouds_tpu/nn/layers.MaskedBatchNorm followed by jax.nn.relu and,
where asked, the row mask (the JAX SparseConvBlock's epilogue), forward,
running statistics and jax.grad, in train and eval mode, at C = 4 and 64,
float32 and bfloat16, with an all-false mask and with rows outside the mask
that receive a gradient (the perturber, which has no row mask). Inputs come
from a numpy seed. The launch plan of the card's kernels is plain Python and
is checked here too.
"""
import os
import re

import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.nn import layers as jlayers

import robustpointclouds_tpu_torch.kernels.masked_stats as ks
from robustpointclouds_tpu_torch.kernels.masked_stats import (
    masked_batch_norm, masked_batch_norm_bwd_ref, masked_batch_norm_ref, masked_stats_ref,
    row_plan)
from robustpointclouds_tpu_torch.nn import layers as tlayers

N = 257  # not a multiple of any tile
CASES = [(train, c, dtype, row_mask, all_masked)
         for train in (True, False) for c in (4, 64) for dtype in ("float32", "bfloat16")
         for row_mask in (False, True) for all_masked in (False, True)]
IDS = [f"{'train' if t else 'eval'}-C{c}-{d}-{'rowmask' if r else 'relu'}"
       f"{'-allmasked' if a else ''}" for t, c, d, r, a in CASES]


def _data(c, dtype, all_masked, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, c) * 3 + 1).astype(np.float32)
    if dtype == "bfloat16":  # values the bf16 input holds exactly
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    mask = np.zeros(N, bool) if all_masked else rng.rand(N) < 0.7
    params = {"scale": (0.5 + rng.rand(c)).astype(np.float32),
              "bias": rng.randn(c).astype(np.float32)}
    stats = {"mean": rng.randn(c).astype(np.float32),
             "var": (0.5 + rng.rand(c)).astype(np.float32)}
    # the output cotangent, nonzero on every row, exact in bfloat16
    g = torch.from_numpy(rng.randn(N, c).astype(np.float32)).to(torch.bfloat16).float().numpy()
    return x, mask, params, stats, g


def _jax_forward(x, mask, params, stats, train, row_mask, dtype):
    """flax MaskedBatchNorm, jax.nn.relu and the row mask; (y, batch_stats)."""
    y, upd = jlayers.MaskedBatchNorm(dtype=jnp.dtype(dtype)).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(mask), train,
        mutable=["batch_stats"])
    y = jax.nn.relu(y)
    if row_mask:
        y = jnp.where(jnp.asarray(mask)[:, None], y, jnp.zeros_like(y))
    return y, upd["batch_stats"]


def _port_bn(params, stats, train):
    bn = tlayers.MaskedBatchNorm(params["scale"].shape[0])
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"].copy()),
                        "running_var": torch.from_numpy(stats["var"].copy()),
                        "num_batches_tracked": torch.tensor(0)})
    return bn.train(train)


def _within_bf16_bracket(got, ref, delta):
    """got (bf16) is the rounding of some value within delta of ref (float32)."""
    lo = torch.from_numpy(ref - delta).to(torch.bfloat16).float()
    hi = torch.from_numpy(ref + delta).to(torch.bfloat16).float()
    return bool(((got.float() >= lo) & (got.float() <= hi)).all())


@pytest.mark.parametrize("train,c,dtype,row_mask,all_masked", CASES, ids=IDS)
def test_forward_and_running_stats_match_flax(train, c, dtype, row_mask, all_masked):
    x, mask, params, stats, _ = _data(c, dtype, all_masked, seed=c)
    tdt = getattr(torch, dtype)
    bn = _port_bn(params, stats, train)
    with torch.no_grad():
        got = bn(torch.from_numpy(x).to(tdt), torch.from_numpy(mask), relu=True,
                 row_mask=row_mask, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (N, c)
    yf, upd = _jax_forward(x, mask, params, stats, train, row_mask, "float32")
    yf = np.asarray(yf)
    # float32 on both sides, statistics summed in another order: 1e-6 of scale
    delta = 1e-6 * max(np.abs(yf).max(), 1e-6)
    if dtype == "float32":
        assert np.abs(got.numpy() - yf).max() <= delta
    else:
        # one bf16 rounding of a float32 value within 1e-6 of scale of flax's;
        # where that value cannot straddle a rounding boundary, flax's bf16 output exactly
        assert _within_bf16_bracket(got, yf, delta)
        yb = np.array(_jax_forward(x, mask, params, stats, train, row_mask, "bfloat16")[0]
                      .astype(jnp.float32))
        firm = (torch.from_numpy(yf - delta).to(tdt) == torch.from_numpy(yf + delta).to(tdt))
        assert torch.equal(got.float()[firm], torch.from_numpy(yb)[firm])
    if row_mask:
        assert got.float()[~torch.from_numpy(mask)].abs().max().item() == 0.0
    for ours, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        ref = np.asarray(upd[key])
        assert np.abs(ours.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("train,c,dtype,row_mask,all_masked", CASES, ids=IDS)
def test_grads_match_jax_grad(train, c, dtype, row_mask, all_masked):
    x, mask, params, stats, g = _data(c, dtype, all_masked, seed=100 + c)
    tdt = getattr(torch, dtype)
    mj = jnp.asarray(mask)

    def loss(xa, p):
        y = jlayers.MaskedBatchNorm(dtype=jnp.dtype(dtype)).apply(
            {"params": p, "batch_stats": stats}, xa, mj, train, mutable=["batch_stats"])[0]
        y = jax.nn.relu(y)
        if row_mask:
            y = jnp.where(mj[:, None], y, jnp.zeros_like(y))
        return jnp.sum(y.astype(jnp.float32) * g)
    jx, jp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), params)
    jx = np.asarray(jx)

    bn = _port_bn(params, stats, train)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = bn(xt, torch.from_numpy(mask), relu=True, row_mask=row_mask, out_dtype=tdt)
    assert type(y.grad_fn).__name__ == "MaskedBatchNormFunctionBackward"
    (y.float() * torch.from_numpy(g)).sum().backward()
    assert xt.grad.dtype == tdt
    # float32 both sides; the statistics' VJP analytic here, autodiff of the
    # two-pass form in JAX: 1e-5 of the largest gradient
    for got, ref in ((bn.weight.grad.numpy(), np.asarray(jp["scale"])),
                     (bn.bias.grad.numpy(), np.asarray(jp["bias"]))):
        assert np.abs(got - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1e-6)
    delta = 1e-5 * max(np.abs(jx).max(), 1e-6)
    if dtype == "float32":
        assert np.abs(xt.grad.numpy() - jx).max() <= delta
    else:  # dx rounds once to bf16
        assert _within_bf16_bracket(xt.grad, jx, delta)
    outside = xt.grad.float()[~torch.from_numpy(mask)].abs()
    if row_mask:  # masked rows' outputs are constant zeros
        assert outside.max().item() == 0.0
    elif outside.numel():  # the perturber's case: rows outside the mask pass their gradient on
        assert outside.max().item() > 0.0


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("c", [4, 64])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row_mask", [False, True])
def test_bwd_ref_matches_autograd_of_composition(train, c, out_dtype, row_mask):
    x, mask, params, stats, g = _data(c, "float32", False, seed=200 + c)
    xt = torch.from_numpy(x).requires_grad_(True)
    mt = torch.from_numpy(mask)
    w = torch.from_numpy(params["scale"]).requires_grad_(True)
    b = torch.from_numpy(params["bias"]).requires_grad_(True)
    rm, rv = torch.from_numpy(stats["mean"].copy()), torch.from_numpy(stats["var"].copy())
    y = masked_batch_norm_ref(xt, mt, w, b, rm, rv, train, relu=True, row_mask=row_mask,
                              out_dtype=out_dtype)
    (y.float() * torch.from_numpy(g)).sum().backward()
    if train:
        mean, var, cnt = masked_stats_ref(torch.from_numpy(x), mt)
    else:
        mean, var, cnt = torch.from_numpy(stats["mean"]), torch.from_numpy(stats["var"]), None
    dx, dw, db = masked_batch_norm_bwd_ref(torch.from_numpy(g).to(out_dtype), torch.from_numpy(x),
                                           mt, w.detach(), b.detach(), mean, var, cnt, 1e-3,
                                           train, relu=True, row_mask=row_mask)
    # the same float32 arithmetic up to the statistics' VJP (analytic vs
    # autodiff of the two passes): 1e-6 of the largest gradient
    for got, ref in ((dx, xt.grad), (dw, w.grad), (db, b.grad)):
        assert got.dtype == ref.dtype
        assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


def test_cpu_calls_count_no_launch():
    # CPU tensors take the plain versions: no counter moves
    x, mask, params, stats, _ = _data(16, "float32", False, seed=3)
    counters = (ks.masked_stats, ks.masked_stats_bwd, masked_batch_norm,
                ks.masked_batch_norm_bwd)
    before = [f.launches for f in counters] + [ks.masked_batch_norm_bwd.reduce_launches,
                                               dict(ks.KERNEL_LAUNCHES)]
    xt = torch.from_numpy(x).requires_grad_(True)
    _port_bn(params, stats, True)(xt, torch.from_numpy(mask), relu=True).sum().backward()
    ks.masked_stats(xt, torch.from_numpy(mask))[1].sum().backward()
    assert [f.launches for f in counters] + [ks.masked_batch_norm_bwd.reduce_launches,
                                             dict(ks.KERNEL_LAUNCHES)] == before


# ---- the card's launch plan (plain Python)

# every (N, C) a MaskedBatchNorm of the default SECOND config normalises:
# the perturber's five over the 480000 point slots, the encoder's twelve
MAIN_PATH = [(480000, 64), (480000, 128), (96000, 16), (96000, 32), (72000, 64), (48000, 64),
             (48000, 128), (480000, 4)]


@pytest.mark.parametrize("c", ks.WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 255, 257, 480000])
def test_row_plan_covers_every_width(c, dtype, n):
    for reduce in (True, False):
        p = row_plan(n, c, dtype, reduce)
        assert p.vec * p.lanes == c and p.lanes <= 32 and 32 % p.lanes == 0
        # a thread's load: 16 bytes, or 8 for a 4-channel bf16 row, or two
        # 16-byte loads for a 256-channel float32 row (which then fills a warp)
        want = 8 if (dtype == torch.bfloat16 and c == 4) else 16
        if dtype == torch.float32 and c == 256:
            want = 32
        assert p.vec * dtype.itemsize == want
        assert p.rows_per_block * p.lanes == ks._THREADS
        cap = ks._SMS * ks._BLOCKS_PER_SM  # one wave of resident blocks
        assert 1 <= p.blocks <= cap
        # every row visited; a reduction's thread gets a whole batch of rows
        per_thread = ks._REDUCE_ROWS if reduce else 1
        assert p.blocks == cap or p.blocks * p.rows_per_block * per_thread >= n
        assert p.workspace_floats == (p.blocks * (2 * c + 1) if reduce else 0)


@pytest.mark.parametrize("n,c", MAIN_PATH)
def test_row_plan_fills_the_card_on_the_main_path(n, c):
    for reduce in (True, False):
        p = row_plan(n, c, torch.bfloat16 if c > 4 else torch.float32, reduce)
        # every SM busy, in one wave, or a whole batch of rows per thread
        batches = -(-n // (p.rows_per_block * (ks._REDUCE_ROWS if reduce else 1)))
        assert min(ks._SMS, batches) <= p.blocks <= ks._SMS * ks._BLOCKS_PER_SM
        assert p.workspace_floats * 4 <= 300 * 1024  # the partials stay small, in L2


@pytest.mark.parametrize("n,c,dtype", [(10, 3, torch.float32), (10, 512, torch.bfloat16),
                                       (10, 12, torch.float32), (10, 16, torch.float16),
                                       (0, 16, torch.float32)])
def test_row_plan_refuses(n, c, dtype):
    with pytest.raises(ValueError):
        row_plan(n, c, dtype, True)


def test_constants_match_the_cuda_source():
    src = open(os.path.join(os.path.dirname(ks.__file__), "..", "csrc", "masked_stats.cu")).read()
    assert int(re.search(r"kThreads = (\d+);", src).group(1)) == ks._THREADS
    assert int(re.search(r"kMaxC = (\d+);", src).group(1)) == max(ks.WIDTHS)
    assert int(re.search(r"kMinBlocks = (\d+);", src).group(1)) == ks._BLOCKS_PER_SM
    assert int(re.search(r"kStatsUnroll = (\d+);", src).group(1)) == ks._REDUCE_ROWS
    assert int(re.search(r"kVec4MaxC = (\d+);", src).group(1)) == ks._VEC4_MAX_C
    for name in ("stats_kernel", "apply_kernel", "bwd_reduce_kernel", "dx_kernel", "vjp_kernel"):
        assert f"__global__ void __launch_bounds__(kThreads, kMinBlocks)\n{name}" in src
