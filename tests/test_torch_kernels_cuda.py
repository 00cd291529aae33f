"""The port's hand-written kernels against their plain PyTorch versions, on the card.

Marked `cuda` and skipped where there is no NVIDIA card. This file imports
torch only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import ctypes

import pytest
import torch

import robustpointclouds_tpu_torch.kernels.sparse_conv as sparse_conv_module
import robustpointclouds_tpu_torch.kernels.masked_stats as masked_stats_module
from robustpointclouds_tpu_torch.kernels.masked_stats import (
    masked_batch_norm, masked_batch_norm_bwd, masked_batch_norm_bwd_ref, masked_stats,
    masked_stats_bwd, masked_stats_bwd_ref, masked_stats_ref)
from robustpointclouds_tpu_torch.kernels.sparse_conv import (
    backward_kernel, sparse_conv, sparse_conv_cuda_cores, sparse_conv_dgrad, sparse_conv_ref,
    sparse_conv_train, sparse_conv_wgrad, sparse_conv_wgrad_cuda_cores, sparse_conv_wgrad_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,cin,cout,k", [
    (torch.bfloat16, 4, 16, 27), (torch.bfloat16, 64, 128, 3), (torch.bfloat16, 64, 64, 27),
    (torch.float32, 32, 64, 27)])
def test_sparse_conv_matches_plain_version(cuda_device, dtype, cin, cout, k):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, m = 5000, 4000
    feats = torch.randn(n, cin, device=cuda_device, generator=g).to(dtype)
    kernel = (torch.randn(k * cin, cout, device=cuda_device, generator=g) * 0.2).to(dtype)
    # indices in [0, n]: n is the miss row; about 1 in 3 taps miss
    idx = torch.randint(0, 3 * n // 2, (m, k), device=cuda_device, generator=g,
                        dtype=torch.int32).clamp_(max=n)
    before = sparse_conv.launches
    out = sparse_conv(feats, kernel, idx)
    ref = sparse_conv_ref(feats, kernel, idx)
    assert sparse_conv.launches == before + 1
    # one output rounding of the type (bf16: 2^-8) after float32 sums in another order
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


def test_sparse_conv_rejects_what_it_cannot_take(cuda_device):
    feats = torch.zeros(10, 4, device=cuda_device)
    idx = torch.zeros(5, 27, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # Cout must divide 256
        sparse_conv(feats, torch.zeros(27 * 4, 24, device=cuda_device), idx)
    with pytest.raises(TypeError):  # int64 index
        sparse_conv(feats, torch.zeros(27 * 4, 16, device=cuda_device), idx.long())


# (Cin, Cout, K) of every conv of the full-width SECOND encoder
ENCODER_CONVS = [(4, 16, 27), (16, 16, 27), (16, 32, 27), (32, 32, 27), (32, 64, 27),
                 (64, 64, 27), (64, 128, 3)]


def _missing_to_n(idx, n):
    """The plain versions read row n for a miss: map every index outside [0, n) there."""
    return torch.where((idx < 0) | (idx >= n), torch.full_like(idx, n), idx)


def _tc_index(dev, g, n, m, k):
    """Random [m, k] indices with about 1 in 3 missing, as n, n + 7 and 2^31 - 1
    and negative values; rows 64-127 (one whole tile) miss every tap."""
    idx = torch.randint(0, 3 * n // 2, (m, k), device=dev, generator=g, dtype=torch.int32)
    idx[idx >= n] = n
    idx[::5, 0] = n + 7
    idx[1::7, -1] = 2 ** 31 - 1
    idx[2::11, k // 2] = -3
    idx[64:128] = n
    return idx


def _local_index(dev, side=24, k_side=3):
    """A sorted, spatially local submanifold index: the active sites of a
    [side, side, side] grid where only the planes z = 0 and z = 2 are active, so
    whole tiles of sorted rows miss every tap with dz = 0 rows of the other plane."""
    z, y, x = torch.meshgrid(torch.arange(side), torch.arange(side), torch.arange(side),
                             indexing="ij")
    active = (z == 0) | (z == 2)
    coords = torch.stack([z[active], y[active], x[active]], 1)  # sorted by (z, y, x)
    n = coords.shape[0]
    lut = torch.full((side + 2,) * 3, n, dtype=torch.int32)
    lut[coords[:, 0] + 1, coords[:, 1] + 1, coords[:, 2] + 1] = torch.arange(n, dtype=torch.int32)
    r = torch.arange(k_side) - k_side // 2
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    nb = coords[:, None, :] + offs[None] + 1
    inside = ((nb >= 0) & (nb < side + 2)).all(-1)
    nb = nb.clamp(0, side + 1)
    idx = torch.where(inside, lut[nb[..., 0], nb[..., 1], nb[..., 2]], torch.tensor(n, dtype=torch.int32))
    return idx.to(dev).contiguous(), n


@pytest.mark.parametrize("cin,cout,k", ENCODER_CONVS + [(16, 16, 1)])
def test_sparse_conv_tensor_cores_encoder_widths(cuda_device, cin, cout, k):
    # bf16 launches the tensor-core kernel (no CUDA-core launch is counted);
    # M = 4037 is not a multiple of the 64-row tile
    g = torch.Generator(device=cuda_device).manual_seed(5)
    n, m = 3000, 4037
    feats = torch.randn(n, cin, device=cuda_device, generator=g).to(torch.bfloat16)
    kernel = (torch.randn(k * cin, cout, device=cuda_device, generator=g) * 0.2).to(torch.bfloat16)
    idx = _tc_index(cuda_device, g, n, m, k)
    before = (sparse_conv.launches, sparse_conv.cuda_core_launches)
    out = sparse_conv(feats, kernel, idx)
    ref = sparse_conv_ref(feats, kernel, _missing_to_n(idx, n))
    assert (sparse_conv.launches, sparse_conv.cuda_core_launches) == (before[0] + 1, before[1])
    assert out.shape == (m, cout) and out.dtype == torch.bfloat16
    # one bf16 output rounding (2^-8) after float32 sums in another order
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    assert out[64:128].abs().max().item() == 0.0  # the tile that misses every tap


@pytest.mark.parametrize("tile_m", [16, 128])
@pytest.mark.parametrize("cin,cout", [(32, 16), (4, 16), (64, 128), (128, 64)])
def test_sparse_conv_tensor_cores_other_tile_rows(cuda_device, monkeypatch, tile_m, cin, cout):
    # the kernel takes any multiple of 16 rows up to 128 (a warp per 16);
    # (32, 16) at 128 rows needs exactly 48 KB of dynamic shared memory
    monkeypatch.setattr(sparse_conv_module, "_TC_TILE_M", tile_m)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    n, m = 2000, 1537
    feats = torch.randn(n, cin, device=cuda_device, generator=g).to(torch.bfloat16)
    kernel = (torch.randn(27 * cin, cout, device=cuda_device, generator=g) * 0.2).to(torch.bfloat16)
    idx = _tc_index(cuda_device, g, n, m, 27)
    out = sparse_conv(feats, kernel, idx)
    ref = sparse_conv_ref(feats, kernel, _missing_to_n(idx, n))
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()


@pytest.mark.parametrize("cin,cout,k", ENCODER_CONVS)
@pytest.mark.parametrize("mirror", [True, False])
def test_sparse_conv_dgrad_tensor_cores_encoder_widths(cuda_device, cin, cout, k, mirror):
    # d_feats has Cin columns (4 for conv_input: the n-padded case); the
    # gathered rows are g's Cout columns
    g = torch.Generator(device=cuda_device).manual_seed(6)
    n, m = 4037, 3000
    grad = torch.randn(m, cout, device=cuda_device, generator=g).to(torch.bfloat16)
    w = (torch.randn(k * cin, cout, device=cuda_device, generator=g) * 0.2).to(torch.bfloat16)
    bwd_idx = _tc_index(cuda_device, g, m, n, k)
    w_bwd = backward_kernel(w, k, mirror)
    before = (sparse_conv_dgrad.launches, sparse_conv_dgrad.cuda_core_launches)
    out = sparse_conv_dgrad(grad, w_bwd, bwd_idx)
    ref = sparse_conv_ref(grad, w_bwd, _missing_to_n(bwd_idx, m))
    assert (sparse_conv_dgrad.launches, sparse_conv_dgrad.cuda_core_launches) == (
        before[0] + 1, before[1])
    assert out.shape == (n, cin) and out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()


@pytest.mark.parametrize("cin,cout", [(4, 16), (16, 32), (64, 64)])
def test_sparse_conv_tensor_cores_local_sorted_index(cuda_device, cin, cout):
    # whole tiles of a sorted, local index miss some taps (dead taps are
    # skipped as a whole); both kernels against the plain versions
    idx, n = _local_index(cuda_device)
    idx[128:192] = n  # and one tile that misses every tap
    g = torch.Generator(device=cuda_device).manual_seed(7)
    feats = torch.randn(n, cin, device=cuda_device, generator=g).to(torch.bfloat16)
    kernel = (torch.randn(27 * cin, cout, device=cuda_device, generator=g) * 0.2).to(torch.bfloat16)
    grad = torch.randn(n, cout, device=cuda_device, generator=g).to(torch.bfloat16)
    out = sparse_conv(feats, kernel, idx)
    ref = sparse_conv_ref(feats, kernel, idx)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    dw = sparse_conv_wgrad(feats, grad, idx)
    dw_ref = sparse_conv_wgrad_ref(feats, grad, idx)
    assert (dw - dw_ref).abs().max().item() <= 1e-4 * dw_ref.abs().max().item()


@pytest.mark.parametrize("cin,cout,k", ENCODER_CONVS)
def test_sparse_conv_wgrad_tensor_cores_encoder_widths(cuda_device, cin, cout, k):
    g = torch.Generator(device=cuda_device).manual_seed(8)
    n, m = 3000, 4037
    feats = torch.randn(n, cin, device=cuda_device, generator=g).to(torch.bfloat16)
    grad = torch.randn(m, cout, device=cuda_device, generator=g).to(torch.bfloat16)
    idx = _tc_index(cuda_device, g, n, m, k)
    before = (sparse_conv_wgrad.launches, sparse_conv_wgrad.cuda_core_launches)
    dw = sparse_conv_wgrad(feats, grad, idx)
    ref = sparse_conv_wgrad_ref(feats, grad, _missing_to_n(idx, n))
    assert (sparse_conv_wgrad.launches, sparse_conv_wgrad.cuda_core_launches) == (
        before[0] + 1, before[1])
    assert dw.shape == (k * cin, cout) and dw.dtype == torch.float32
    # float32 sums of the same exact bf16 products in another order: 1e-4 of scale
    assert (dw - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    # deterministic: fixed hit lists, fixed warp split, fixed-order reduce
    assert torch.equal(dw, sparse_conv_wgrad(feats, grad, idx))


@pytest.mark.parametrize("smem_bytes", [1536, 6144, 24576])
@pytest.mark.parametrize("cin,cout", [(4, 16), (32, 64), (64, 128)])
def test_sparse_conv_wgrad_tensor_cores_short_hit_lists(cuda_device, monkeypatch, smem_bytes,
                                                        cin, cout):
    # a small budget gives hit lists of 16-64 entries, flushed many times per tap
    monkeypatch.setattr(sparse_conv_module, "_TC_WGRAD_SMEM_BYTES", smem_bytes)
    feats, grad, idx = _conv_inputs(cuda_device, torch.bfloat16, 3000, 2500, cin, cout, 27, seed=3)
    dw = sparse_conv_wgrad(feats, grad, idx)
    ref = sparse_conv_wgrad_ref(feats, grad, idx)
    assert (dw - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert torch.equal(dw, sparse_conv_wgrad(feats, grad, idx))


def test_float32_takes_the_cuda_core_kernels(cuda_device):
    # the float32 route: every wrapper counts a CUDA-core launch, and the
    # CUDA-core kernels, launched directly, count nothing
    feats, grad, idx = _conv_inputs(cuda_device, torch.float32, 2000, 1500, 16, 32, 27, seed=4)
    kernel = torch.randn(27 * 16, 32, device=cuda_device) * 0.2
    fns = (sparse_conv, sparse_conv_dgrad, sparse_conv_wgrad)
    before = [(f.launches, f.cuda_core_launches) for f in fns]
    out = sparse_conv(feats, kernel, idx)
    d_feats = sparse_conv_dgrad(grad, backward_kernel(kernel, 27, True), idx)
    dw = sparse_conv_wgrad(feats, grad, idx)
    assert [(f.launches, f.cuda_core_launches) for f in fns] == [(a + 1, b + 1) for a, b in before]
    assert torch.equal(out, sparse_conv_cuda_cores(feats, kernel, idx))
    assert torch.equal(dw, sparse_conv_wgrad_cuda_cores(feats, grad, idx))
    assert [(f.launches, f.cuda_core_launches) for f in fns] == [(a + 1, b + 1) for a, b in before]
    assert d_feats.shape == (idx.shape[0], 16)  # one row per backward-index row


def test_tensor_cores_reject_what_they_cannot_take(cuda_device):
    idx = torch.zeros(5, 27, dtype=torch.int32, device=cuda_device)
    bf = torch.bfloat16
    with pytest.raises(ValueError):  # 6 channels: not whole 8-byte pieces
        sparse_conv(torch.zeros(10, 6, device=cuda_device, dtype=bf),
                    torch.zeros(27 * 6, 16, device=cuda_device, dtype=bf), idx)
    with pytest.raises(ValueError):  # wider than the largest instance
        sparse_conv(torch.zeros(10, 256, device=cuda_device, dtype=bf),
                    torch.zeros(27 * 256, 16, device=cuda_device, dtype=bf), idx)
    with pytest.raises(ValueError):  # a base 8 bytes past a 16-byte boundary
        sparse_conv(torch.zeros(11, 4, device=cuda_device, dtype=bf)[1:],
                    torch.zeros(27 * 4, 16, device=cuda_device, dtype=bf), idx)
    with pytest.raises(ValueError):  # more taps than the live-tap mask holds
        sparse_conv(torch.zeros(10, 16, device=cuda_device, dtype=bf),
                    torch.zeros(33 * 16, 16, device=cuda_device, dtype=bf),
                    torch.zeros(5, 33, dtype=torch.int32, device=cuda_device))


@pytest.mark.parametrize("n,c,dtype", [(480000, 4, torch.float32), (96000, 64, torch.bfloat16),
                                       (1000, 8, torch.float32)])
def test_masked_stats_matches_plain_version(cuda_device, n, c, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(n, c, device=cuda_device, generator=g) * 3 + 1).to(dtype)
    mask = torch.rand(n, device=cuda_device, generator=g) > 0.75
    before = masked_stats.launches
    mean, var, cnt = masked_stats(x, mask)
    assert masked_stats.launches == before + 1
    rm, rv, rc = masked_stats_ref(x, mask)
    # float32 statistics, one pass merged by Chan's formula vs two passes
    torch.testing.assert_close(mean, rm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(var, rv, rtol=1e-4, atol=1e-4)
    assert cnt.item() == rc.item()


@pytest.mark.parametrize("c", masked_stats_module.WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 4097, 300001])
def test_masked_stats_every_width_is_deterministic(cuda_device, c, dtype, n):
    # ragged N (not a multiple of any block's rows), N = 1, every width and
    # type; a large offset checks that nothing takes E[x^2] - mean^2
    g = torch.Generator(device=cuda_device).manual_seed(c + n)
    x = (torch.randn(n, c, device=cuda_device, generator=g) * 2 + 100).to(dtype)
    mask = torch.rand(n, device=cuda_device, generator=g) > 0.5
    mask[0] = True
    mean, var, cnt = masked_stats(x, mask)
    rm, rv, rc = masked_stats_ref(x, mask)
    assert cnt.item() == rc.item()
    torch.testing.assert_close(mean, rm, rtol=1e-5, atol=1e-5)
    # float32 variance of values around 100: Chan's merge keeps 1e-4 of it
    torch.testing.assert_close(var, rv, rtol=1e-4, atol=1e-4 * max(rv.max().item(), 1.0))
    m2, v2, c2 = masked_stats(x, mask)  # a fixed merge order: bit-identical
    assert torch.equal(m2, mean) and torch.equal(v2, var) and torch.equal(c2, cnt)


def test_masked_stats_all_masked(cuda_device):
    x = torch.ones(64, 4, device=cuda_device)
    mean, var, cnt = masked_stats(x, torch.zeros(64, dtype=torch.bool, device=cuda_device))
    assert cnt.item() == 0.0
    assert mean.abs().max().item() == 0.0 and var.abs().max().item() == 0.0


def _conv_inputs(dev, dtype, n, m, cin, cout, k, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn(n, cin, device=dev, generator=g).to(dtype)
    grad = torch.randn(m, cout, device=dev, generator=g).to(dtype)
    # indices in [0, n]: n is the miss row; about 1 in 3 taps miss
    idx = torch.randint(0, 3 * n // 2, (m, k), device=dev, generator=g,
                        dtype=torch.int32).clamp_(max=n)
    return feats, grad, idx


@pytest.mark.parametrize("dtype,cin,cout,k", [
    (torch.bfloat16, 4, 16, 27), (torch.bfloat16, 16, 32, 27), (torch.bfloat16, 64, 128, 3),
    (torch.bfloat16, 64, 64, 27), (torch.float32, 32, 64, 27), (torch.float32, 32, 16, 27)])
def test_sparse_conv_wgrad_matches_plain_version(cuda_device, dtype, cin, cout, k):
    feats, grad, idx = _conv_inputs(cuda_device, dtype, 5000, 4000, cin, cout, k)
    before = sparse_conv_wgrad.launches
    dw = sparse_conv_wgrad(feats, grad, idx)
    ref = sparse_conv_wgrad_ref(feats, grad, idx)
    assert sparse_conv_wgrad.launches == before + 1 and dw.dtype == torch.float32
    # float32 sums of the same products in another order (inputs already in
    # the working type): 1e-4 of the output's scale
    err = (dw - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item()
    # deterministic: the partials are summed in a fixed order
    assert torch.equal(dw, sparse_conv_wgrad(feats, grad, idx))


@pytest.mark.parametrize("smem_floats", [96, 1536, 6144])
@pytest.mark.parametrize("cin,cout", [(4, 16), (32, 64), (64, 64)])
def test_sparse_conv_wgrad_short_hit_lists(cuda_device, monkeypatch, smem_floats, cin, cout):
    # a small shared-memory budget gives a short hit list, so each block
    # stages and flushes it many times per tap
    monkeypatch.setattr(sparse_conv_module, "_WGRAD_SMEM_FLOATS", smem_floats)
    feats, grad, idx = _conv_inputs(cuda_device, torch.float32, 3000, 2500, cin, cout, 27, seed=3)
    dw = sparse_conv_wgrad(feats, grad, idx)
    ref = sparse_conv_wgrad_ref(feats, grad, idx)
    # float32 sums of the same products in another order: 1e-4 of scale
    assert (dw - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.parametrize("dtype,cin,cout,k,mirror", [
    (torch.bfloat16, 4, 16, 27, True), (torch.bfloat16, 64, 128, 3, False),
    (torch.bfloat16, 32, 64, 27, False), (torch.float32, 16, 32, 27, True)])
def test_sparse_conv_dgrad_matches_plain_version(cuda_device, dtype, cin, cout, k, mirror):
    # d_feats has Cin columns: every dgrad width of the encoder (4, 16, 32, 64)
    # must divide 256
    g = torch.Generator(device=cuda_device).manual_seed(1)
    n, m = 5000, 4000
    grad = torch.randn(m, cout, device=cuda_device, generator=g).to(dtype)
    w = torch.randn(k * cin, cout, device=cuda_device, generator=g) * 0.2
    bwd_idx = torch.randint(0, 3 * m // 2, (n, k), device=cuda_device, generator=g,
                            dtype=torch.int32).clamp_(max=m)
    w_bwd = backward_kernel(w.to(dtype), k, mirror)
    before = sparse_conv_dgrad.launches
    out = sparse_conv_dgrad(grad, w_bwd, bwd_idx)
    ref = sparse_conv_ref(grad, w_bwd, bwd_idx)
    assert sparse_conv_dgrad.launches == before + 1 and out.dtype == dtype
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5  # one output rounding of the type
    assert (out.float() - ref.float()).abs().max().item() <= tol * ref.float().abs().max().item()


def test_sparse_conv_function_backward_on_card_matches_cpu(cuda_device):
    # a float32 subm conv through the autograd Function: the card's kernels
    # against the CPU's plain versions on the same inputs
    feats, grad, idx = _conv_inputs(cuda_device, torch.float32, 3000, 3000, 16, 32, 27, seed=2)
    w = torch.randn(27 * 16, 32, device=cuda_device) * 0.2
    res = []
    for dev in (cuda_device, torch.device("cpu")):
        f = feats.to(dev, copy=True).requires_grad_(True)
        ww = w.to(dev, copy=True).requires_grad_(True)
        (sparse_conv_train(f, ww, idx.to(dev), idx.to(dev), True) * grad.to(dev)).sum().backward()
        res.append((f.grad.cpu(), ww.grad.cpu()))
    for a, b in zip(*res):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.parametrize("n,c,dtype", [(480000, 4, torch.float32), (480000, 128, torch.bfloat16),
                                       (96000, 64, torch.float32), (1000, 8, torch.float32)])
def test_masked_stats_bwd_matches_plain_version(cuda_device, n, c, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(n, c, device=cuda_device, generator=g) * 3 + 1).to(dtype)
    mask = torch.rand(n, device=cuda_device, generator=g) > 0.75
    gm = torch.randn(c, device=cuda_device, generator=g)
    gv = torch.randn(c, device=cuda_device, generator=g)
    mean, _, cnt = masked_stats(x, mask)
    for a, b in ((gm, gv), (gm, None), (None, gv)):
        before = masked_stats_bwd.launches
        dx = masked_stats_bwd(x, mask, mean, cnt, a, b)
        ref = masked_stats_bwd_ref(x, mask, mean, cnt, a, b)
        assert masked_stats_bwd.launches == before + 1 and dx.dtype == dtype
        # the same elementwise float32 formula; bf16: one output rounding
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        assert (dx.float() - ref.float()).abs().max().item() <= tol * ref.float().abs().max().item()


def test_masked_stats_autograd_launches_the_vjp(cuda_device):
    x = torch.randn(2048, 8, device=cuda_device, requires_grad=True)
    mask = torch.rand(2048, device=cuda_device) > 0.5
    before = masked_stats_bwd.launches
    mean, var, _ = masked_stats(x, mask)
    (mean.sum() + var.sum()).backward()
    assert masked_stats_bwd.launches == before + 1
    xc = x.detach().cpu().requires_grad_(True)
    m2, v2, _ = masked_stats(xc, mask.cpu())
    (m2.sum() + v2.sum()).backward()
    assert (x.grad.cpu() - xc.grad).abs().max().item() <= 1e-5


@pytest.mark.parametrize("kernel", ["gather_rows", "gather_elems", "gather_row_loop",
                                    "gather_onehot"])
@pytest.mark.parametrize("dtype,n,c,m", [
    (torch.float32, 512, 128, 256), (torch.float32, 777, 36, 4099),
    (torch.bfloat16, 96, 64, 1001), (torch.bfloat16, 5000, 8, 12345)])
def test_gather_kernels_match_plain_version(cuda_device, kernel, dtype, n, c, m):
    import robustpointclouds_tpu_torch.kernels.gather as gmod

    fn = getattr(gmod, kernel)
    plain = gmod.gather_onehot_ref if kernel == "gather_onehot" else gmod.gather_ref
    if kernel == "gather_onehot" and n * m > 10 ** 7:
        m = 1000  # the one-hot product reads the whole table per 32 rows
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(n, c, device=cuda_device, generator=g).to(dtype)
    # indices in [0, n]: n is the miss row and reads zeros; ragged m
    idx = torch.randint(0, n + 1, (m,), device=cuda_device, generator=g, dtype=torch.int32)
    idx[:3] = n
    before = fn.launches
    out = fn(x, idx)
    assert fn.launches == before + 1 and out.dtype == dtype and out.shape == (m, c)
    # a copy, and a float32 sum of one non-zero product: exact
    assert torch.equal(out, plain(x, idx))
    assert out[:3].abs().max().item() == 0.0


def test_gather_rows_rejects_unaligned_rows(cuda_device):
    from robustpointclouds_tpu_torch.kernels.gather import gather_rows

    idx = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # 6 floats = 24 bytes: not 16-byte vectors
        gather_rows(torch.zeros(10, 6, device=cuda_device), idx)
    with pytest.raises(TypeError):
        gather_rows(torch.zeros(10, 8, device=cuda_device), idx.long())


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _gather_inputs(dev, dtype, n, c, m, seed, specials=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, c, device=dev, generator=g)
    x = x * torch.exp2(torch.randint(-140, 120, (n, c), device=dev, generator=g).float())
    if specials:  # -0, subnormals of both types, extremes, Inf and NaN in row 0
        vals = [0.0, -0.0, 1e-45, -1e-40, 2.0 ** -133, 3.4028235e38, float("inf"),
                float("-inf"), float("nan")]
        x[0, :min(c, len(vals))] = torch.tensor(vals[:c], device=dev)
    x = x.to(dtype)
    # indices in [-2, n]: n and negatives are misses and read zeros; ragged m
    idx = torch.randint(-2, n + 1, (m,), device=dev, generator=g, dtype=torch.int32)
    k = min(m, 4)
    idx[:k] = torch.tensor([n, -1, 0, 0][:k], device=dev, dtype=torch.int32)
    return x, idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,m", [(512, 128, 256), (96, 3, 1001), (777, 72, 4099),
                                   (300, 36, 8193), (5000, 8, 2_300_000), (64, 1, 5)])
def test_gather_row_loop_is_exact(cuda_device, dtype, n, c, m):
    from robustpointclouds_tpu_torch.kernels import gather as gmod

    x, idx = _gather_inputs(cuda_device, dtype, n, c, m, seed=n + c, specials=True)
    plan = gmod.row_loop_plan(m, c, x.element_size(), gmod._align(x))
    if m > 4096:
        assert plan.blocks > 1 and plan.rows_per_block <= 4096
    before = gmod.gather_row_loop.launches
    out = gmod.gather_row_loop(x, idx)
    again = gmod.gather_row_loop(x, idx)
    assert gmod.gather_row_loop.launches == before + 2
    ref = gmod.gather_ref(x, idx.masked_fill(idx < 0, n))
    assert torch.equal(_bits(out), _bits(ref)) and torch.equal(_bits(again), _bits(out))
    assert not _bits(out[:2]).any()  # the misses read +0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 3])
def test_gather_row_loop_takes_unaligned_bases(cuda_device, dtype, offset):
    from robustpointclouds_tpu_torch.kernels import gather as gmod

    big, idx = _gather_inputs(cuda_device, dtype, 401, 16, 3000, seed=7)
    x = big.view(-1)[offset:offset + 400 * 16].view(400, 16)  # a contiguous view off the base
    assert x.data_ptr() % 16
    out = gmod.gather_row_loop(x, idx)
    ref = gmod.gather_ref(x, idx.masked_fill(idx < 0, 400).clamp(max=400))
    assert torch.equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,m", [(512, 128, 256), (96, 3, 1001), (200, 72, 1001),
                                   (130, 36, 4099), (1000, 64, 3), (17, 1, 40)])
def test_gather_onehot_tensor_cores_are_exact(cuda_device, dtype, n, c, m):
    from robustpointclouds_tpu_torch.kernels import gather as gmod

    x, idx = _gather_inputs(cuda_device, dtype, n, c, m, seed=n * c, specials=True)
    before = gmod.gather_onehot.launches
    out = gmod.gather_onehot(x, idx)
    again = gmod.gather_onehot(x, idx)
    assert gmod.gather_onehot.launches == before + 2
    misses = idx.masked_fill(idx < 0, n)
    # x[idx] bit for bit: -0, subnormals, Inf and NaN as they are
    assert torch.equal(_bits(out), _bits(gmod.gather_ref(x, misses)))
    assert torch.equal(_bits(again), _bits(out))
    # the plane arithmetic's plain version gives the same words
    planes = gmod.gather_onehot_planes_ref(x.cpu(), misses.cpu())
    assert torch.equal(_bits(out.cpu()), _bits(planes))
    # on columns of finite, normal values it is the probe's float product
    xf = x.float().abs()
    ok = (torch.isfinite(xf) & ((xf >= torch.finfo(torch.float32).tiny) | (xf == 0))).all(0)
    prod = gmod.gather_onehot_ref(x, misses)
    assert torch.equal(out[:, ok], prod[:, ok])


def test_gather_probe_kernels_reject_what_they_cannot_take(cuda_device):
    from robustpointclouds_tpu_torch.kernels import gather as gmod

    x = torch.zeros(10, 8, device=cuda_device)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    for fn in (gmod.gather_row_loop, gmod.gather_onehot):
        with pytest.raises(TypeError):
            fn(x, idx.long())
        with pytest.raises(TypeError):
            fn(x.half(), idx)
        with pytest.raises(ValueError):
            fn(x.t(), idx)  # not contiguous
        with pytest.raises(ValueError):
            fn(x, idx.cpu())
        with pytest.raises(ValueError):
            fn(x.view(10, 2, 4), idx)
    # the C entry points refuse a plan the inputs do not allow
    out = torch.empty(4, 8, device=cuda_device)
    stream = gmod._stream(x.get_device())
    xs = x.view(-1)[1:73].view(9, 8)  # a base 4 bytes off a 16-byte boundary

    def plan(*fields):
        return (ctypes.c_int64 * len(fields))(*fields)

    row_loop, onehot = gmod._fn("rpc_gather_row_loop"), gmod._fn("rpc_gather_onehot")
    args = (xs.data_ptr(), idx.data_ptr(), out.data_ptr(), 4, 9)
    assert row_loop(*args, plan(8, 4, *gmod.row_loop_plan(4, 8, 4, 4)), stream) == 0
    assert row_loop(*args, plan(8, 4, 16, 2, 128, 8, 1), stream) != 0  # 16-byte vectors
    assert row_loop(*args, plan(8, 4, 4, 8, 64, 8192, 1), stream) != 0  # > 4096 rows staged
    assert onehot(*args, plan(8, 4, *gmod.onehot_plan(4, 8, 4, 4)), stream) == 0
    assert onehot(*args, plan(8, 4, 1, 1, 1, 16, 4), stream) != 0  # 16-byte stages
    assert onehot(*args, plan(8, 4, 3, 1, 1, 0, 4), stream) != 0  # 3 row warps
    assert onehot(*args, plan(8, 4, 1, 2, 1, 0, 4), stream) != 0  # a grid that disagrees
    assert onehot(*args, plan(8, 4, 1, 1, 1, 0, 3), stream) != 0  # float32 takes 4 planes
    torch.cuda.synchronize()


def test_pgd_launches_forward_and_dgrad_but_no_wgrad(cuda_device):
    import numpy as np

    from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
    from robustpointclouds_tpu_torch.eval.attacks import make_plan_attack
    from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

    cfg = tiny_voxelnet_cfg()
    tr = Trainer(cfg, TrainConfig(), device=cuda_device)
    tr.init_state(0)
    b = synthetic_kitti_batch(np.random.RandomState(0), batch_size=2, num_points=512, max_gt=8,
                              num_objects=3, point_range=cfg.voxelizer.point_cloud_range)
    plan = tr.make_plan_builder()(b.points, b.points_mask)
    counters = (sparse_conv, sparse_conv_dgrad, sparse_conv_wgrad, masked_stats, masked_stats_bwd,
                masked_batch_norm, masked_batch_norm_bwd)
    before = [fn.launches for fn in counters] + [masked_batch_norm_bwd.reduce_launches]
    steps = 2
    make_plan_attack(tr, steps=steps)(b, plan)
    torch.cuda.synchronize()
    launched = [fn.launches - n for fn, n in zip(counters, before)]
    launched.append(masked_batch_norm_bwd.reduce_launches - before[-1])
    # per step: the 12 convs' forward and input gradient and the 12 eval-mode
    # BNs' forward and dx; frozen parameters: no wgrad, no bwd_reduce; no adversary
    assert launched == [12 * steps, 12 * steps, 0, 0, 0, 12 * steps, 12 * steps, 0]
    assert all(p.requires_grad for p in tr.model.parameters())


def _bn_inputs(dev, n, c, dtype, seed, mask_kind="random"):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(n, c, device=dev, generator=g) * 3 + 1).to(dtype)
    mask = torch.rand(n, device=dev, generator=g) > 0.4
    if mask_kind == "none":
        mask[:] = False
    weight = 0.5 + torch.rand(c, device=dev, generator=g)
    bias = torch.randn(c, device=dev, generator=g)
    rmean = torch.randn(c, device=dev, generator=g)
    rvar = 0.5 + torch.rand(c, device=dev, generator=g)
    gout = torch.randn(n, c, device=dev, generator=g).to(dtype)
    return x, mask, weight, bias, rmean, rvar, gout


def _close(got, ref, rtol):
    return (got.float() - ref.float()).abs().max().item() <= rtol * max(
        ref.float().abs().max().item(), 1e-6)


# (relu, row_mask): the perturber's ReLU, SparseConvBlock's ReLU + row mask, none
EPILOGUES = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("c", masked_stats_module.WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("relu,row_mask", EPILOGUES)
def test_masked_batch_norm_matches_plain_version(cuda_device, c, dtype, train, relu, row_mask):
    n = 4097  # not a multiple of any block's rows
    x, mask, w, b, rm, rv, gout = _bn_inputs(cuda_device, n, c, dtype, seed=c)
    rm_ref, rv_ref = rm.clone(), rv.clone()
    fns = (masked_batch_norm, masked_batch_norm_bwd)
    before = [f.launches for f in fns] + [masked_batch_norm_bwd.reduce_launches]
    y, mean, var, cnt = masked_stats_module._bn_forward(x, mask, w, b, rm, rv, train, 0.1, 1e-3,
                                                        relu, row_mask, dtype)
    ref, rmean, rvar, rcnt = masked_stats_module._bn_ref(x, mask, w, b, rm_ref, rv_ref, train,
                                                         0.1, 1e-3, relu, row_mask, dtype)
    assert y.dtype == dtype
    # float32: the statistics in another order and one rsqrt; bf16: one output rounding
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _close(y, ref, tol)
    if row_mask:
        assert y[~mask].abs().max().item() == 0.0
    if train:  # one in-place momentum update from the same batch statistics
        assert _close(rm, rm_ref, 1e-5) and _close(rv, rv_ref, 1e-5)
        assert cnt.item() == rcnt.item()
    dx, dw, db = masked_batch_norm_bwd(gout, x, mask, w, b, mean, var, cnt, 1e-3, train, relu,
                                       row_mask)
    rdx, rdw, rdb = masked_batch_norm_bwd_ref(gout, x, mask, w, b, mean, var, cnt, 1e-3, train,
                                              relu, row_mask)
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    # float32 sums over N in another order; bf16 dx: one output rounding
    assert _close(dw, rdw, 1e-4) and _close(db, rdb, 1e-4)
    assert _close(dx, rdx, 1e-4 if dtype == torch.float32 else 1e-2)
    after = [f.launches for f in fns] + [masked_batch_norm_bwd.reduce_launches]
    assert [a - b0 for a, b0 in zip(after, before)] == [1, 1, 1]
    # a repeat call is bit-identical: fixed grid, fixed merge order
    y2 = masked_stats_module._bn_forward(x, mask, w, b, rm.clone(), rv.clone(), train, 0.1, 1e-3,
                                         relu, row_mask, dtype)[0]
    again = masked_batch_norm_bwd(gout, x, mask, w, b, mean, var, cnt, 1e-3, train, relu, row_mask)
    assert torch.equal(y2, y) and all(torch.equal(p, q) for p, q in zip(again, (dx, dw, db)))


@pytest.mark.parametrize("n,mask_kind", [(1, "random"), (1, "none"), (3000, "none")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_batch_norm_one_row_and_empty_mask(cuda_device, n, mask_kind, dtype):
    x, mask, w, b, rm, rv, gout = _bn_inputs(cuda_device, n, 16, dtype, seed=n, mask_kind=mask_kind)
    if mask_kind == "random":
        mask[:] = True
    rm_ref, rv_ref = rm.clone(), rv.clone()
    y, mean, var, cnt = masked_stats_module._bn_forward(x, mask, w, b, rm, rv, True, 0.1, 1e-3,
                                                        True, True, dtype)
    ref, *_ = masked_stats_module._bn_ref(x, mask, w, b, rm_ref, rv_ref, True, 0.1, 1e-3, True,
                                          True, dtype)
    assert cnt.item() == float(mask.sum().item())
    if mask_kind == "none":  # 0 / 0 / 0, as the plain version gives
        assert mean.abs().max().item() == 0.0 and var.abs().max().item() == 0.0
    assert _close(y, ref, 1e-5 if dtype == torch.float32 else 1e-2)
    assert _close(rm, rm_ref, 1e-6) and _close(rv, rv_ref, 1e-6)
    dx, dw, db = masked_batch_norm_bwd(gout, x, mask, w, b, mean, var, cnt, 1e-3, True, True, True)
    rdx, rdw, rdb = masked_batch_norm_bwd_ref(gout, x, mask, w, b, mean, var, cnt, 1e-3, True, True,
                                              True)
    for got, ref_ in ((dx, rdx), (dw, rdw), (db, rdb)):
        assert _close(got, ref_, 1e-4 if got.dtype == torch.float32 else 1e-2)


def test_masked_batch_norm_autograd_reaches_the_backward_kernels(cuda_device):
    from robustpointclouds_tpu_torch.nn.layers import MaskedBatchNorm

    x, mask, w, b, rm, rv, gout = _bn_inputs(cuda_device, 5000, 64, torch.float32, seed=11)
    res = []
    for dev in (cuda_device, torch.device("cpu")):
        bn = MaskedBatchNorm(64).to(dev)
        with torch.no_grad():
            bn.weight.copy_(w)
            bn.bias.copy_(b)
        xx = x.to(dev, copy=True).requires_grad_(True)
        before = (masked_batch_norm_bwd.launches, masked_batch_norm_bwd.reduce_launches)
        y = bn(xx, mask.to(dev), relu=True, row_mask=True)
        (y * gout.to(dev)).sum().backward()
        launched = (masked_batch_norm_bwd.launches - before[0],
                    masked_batch_norm_bwd.reduce_launches - before[1])
        assert launched == ((1, 1) if dev.type == "cuda" else (0, 0))
        res.append([t.detach().cpu() for t in (y, xx.grad, bn.weight.grad, bn.bias.grad,
                                               bn.running_mean, bn.running_var)])
    for got, ref in zip(*res):  # the card's kernels vs the CPU's plain versions, float32
        assert _close(got, ref, 1e-4)


def test_eval_with_frozen_parameters_skips_bwd_reduce(cuda_device):
    x, mask, w, b, rm, rv, gout = _bn_inputs(cuda_device, 3000, 32, torch.bfloat16, seed=12)
    xx = x.clone().requires_grad_(True)
    before = (masked_batch_norm_bwd.launches, masked_batch_norm_bwd.reduce_launches)
    y = masked_batch_norm(xx, mask, w, b, rm, rv, False, relu=True, row_mask=True)
    (y.float() * gout.float()).sum().backward()
    assert (masked_batch_norm_bwd.launches - before[0],
            masked_batch_norm_bwd.reduce_launches - before[1]) == (1, 0)
    rdx = masked_batch_norm_bwd_ref(gout, x, mask, w, b, rm, rv, None, 1e-3, False, True, True)[0]
    assert _close(xx.grad, rdx, 1e-2)


def test_masked_kernels_reject_what_they_cannot_take(cuda_device):
    dev = cuda_device
    mask = torch.ones(10, dtype=torch.bool, device=dev)
    w, b = torch.ones(12, device=dev), torch.zeros(12, device=dev)
    with pytest.raises(ValueError):  # 12 channels: not a supported width
        masked_stats(torch.zeros(10, 12, device=dev), mask)
    with pytest.raises(ValueError):
        masked_batch_norm(torch.zeros(10, 12, device=dev), mask, w, b, torch.zeros(12, device=dev),
                          torch.ones(12, device=dev), True)
    with pytest.raises(ValueError):  # float16
        masked_stats(torch.zeros(10, 16, device=dev, dtype=torch.float16), mask)
    with pytest.raises(ValueError):  # wider than the kernels' 128
        masked_stats(torch.zeros(10, 256, device=dev), mask)
    with pytest.raises(ValueError):  # the mask on another device
        masked_stats(torch.zeros(10, 16, device=dev), mask.cpu())
    with pytest.raises(ValueError):  # a base 4 bytes past a 16-byte boundary
        masked_stats(torch.zeros(41, device=dev)[1:].view(10, 4), mask)
    with pytest.raises(ValueError):  # not contiguous
        masked_stats(torch.zeros(10, 32, device=dev)[:, ::2], mask)
