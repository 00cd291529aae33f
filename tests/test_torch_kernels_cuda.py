"""The port's hand-written kernels against their plain PyTorch versions, on the card.

Marked `cuda` and skipped where there is no NVIDIA card. This file imports
torch only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import ctypes
import os

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
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

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
    with pytest.raises(ValueError):  # a kernel that is not K x Cin rows
        sparse_conv(feats, torch.zeros(27 * 5, 16, device=cuda_device), idx)
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
    # bf16 launches the bf16 tensor-core kernel (no float32 launch is counted);
    # M = 4037 is not a multiple of the 64-row tile
    g = torch.Generator(device=cuda_device).manual_seed(5)
    n, m = 3000, 4037
    feats = torch.randn(n, cin, device=cuda_device, generator=g).to(torch.bfloat16)
    kernel = (torch.randn(k * cin, cout, device=cuda_device, generator=g) * 0.2).to(torch.bfloat16)
    idx = _tc_index(cuda_device, g, n, m, k)
    before = (sparse_conv.launches, sparse_conv.tf32_launches)
    out = sparse_conv(feats, kernel, idx)
    ref = sparse_conv_ref(feats, kernel, _missing_to_n(idx, n))
    assert (sparse_conv.launches, sparse_conv.tf32_launches) == (before[0] + 1, before[1])
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
    before = (sparse_conv_dgrad.launches, sparse_conv_dgrad.tf32_launches)
    out = sparse_conv_dgrad(grad, w_bwd, bwd_idx)
    ref = sparse_conv_ref(grad, w_bwd, _missing_to_n(bwd_idx, m))
    assert (sparse_conv_dgrad.launches, sparse_conv_dgrad.tf32_launches) == (
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
    before = (sparse_conv_wgrad.launches, sparse_conv_wgrad.tf32_launches)
    dw = sparse_conv_wgrad(feats, grad, idx)
    ref = sparse_conv_wgrad_ref(feats, grad, _missing_to_n(idx, n))
    assert (sparse_conv_wgrad.launches, sparse_conv_wgrad.tf32_launches) == (
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
    # the float32 route: every wrapper counts a launch of the 3xTF32
    # tensor-core kernels, held to the plain version at the float32
    # tolerances; the first design's CUDA-core kernels, launched directly as
    # the yardstick, count nothing and agree as well
    assert not torch.backends.cuda.matmul.allow_tf32  # the plain version in full float32
    # N = M: idx in [0, N] serves as the forward and the (mirrored) backward index
    feats, grad, idx = _conv_inputs(cuda_device, torch.float32, 2000, 2000, 16, 32, 27, seed=4)
    kernel = torch.randn(27 * 16, 32, device=cuda_device) * 0.2
    w_bwd = backward_kernel(kernel, 27, True)
    fns = (sparse_conv, sparse_conv_dgrad, sparse_conv_wgrad)
    before = [(f.launches, f.tf32_launches) for f in fns]
    out = sparse_conv(feats, kernel, idx)
    d_feats = sparse_conv_dgrad(grad, w_bwd, idx)
    dw = sparse_conv_wgrad(feats, grad, idx)
    assert [(f.launches, f.tf32_launches) for f in fns] == [(a + 1, b + 1) for a, b in before]
    for got, ref, tol in ((out, sparse_conv_ref(feats, kernel, idx), 1e-5),
                          (d_feats, sparse_conv_ref(grad, w_bwd, idx), 1e-5),
                          (dw, sparse_conv_wgrad_ref(feats, grad, idx), 1e-4)):
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    prev = (sparse_conv_cuda_cores(feats, kernel, idx),
            sparse_conv_wgrad_cuda_cores(feats, grad, idx))
    assert [(f.launches, f.tf32_launches) for f in fns] == [(a + 1, b + 1) for a, b in before]
    assert (prev[0] - out).abs().max().item() <= 1e-5 * out.abs().max().item()
    assert (prev[1] - dw).abs().max().item() <= 1e-4 * dw.abs().max().item()
    assert d_feats.shape == (idx.shape[0], 16)  # one row per backward-index row


@pytest.mark.parametrize("cin,cout,k", ENCODER_CONVS)
def test_sparse_conv_tf32_encoder_widths(cuda_device, cin, cout, k):
    # float32 launches the 3xTF32 kernel: every kind of miss, M = 4037 not a
    # multiple of the 64-row tile, one tile that misses every tap; float32
    # sums in another order: 1e-5 of the output's scale; the same bits again
    g = torch.Generator(device=cuda_device).manual_seed(10)
    n, m = 3000, 4037
    feats = torch.randn(n, cin, device=cuda_device, generator=g)
    kernel = torch.randn(k * cin, cout, device=cuda_device, generator=g) * 0.2
    idx = _tc_index(cuda_device, g, n, m, k)
    before = (sparse_conv.launches, sparse_conv.tf32_launches)
    out = sparse_conv(feats, kernel, idx)
    assert (sparse_conv.launches, sparse_conv.tf32_launches) == (before[0] + 1, before[1] + 1)
    ref = sparse_conv_ref(feats, kernel, _missing_to_n(idx, n))
    assert out.shape == (m, cout) and out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert out[64:128].abs().max().item() == 0.0  # the tile that misses every tap
    assert torch.equal(out, sparse_conv(feats, kernel, idx))


@pytest.mark.parametrize("tile_m,cin,cout", [(16, 32, 16), (128, 4, 16), (48, 64, 128),
                                            (128, 128, 64)])
def test_sparse_conv_tf32_other_tile_rows(cuda_device, monkeypatch, tile_m, cin, cout):
    # the kernel takes any multiple of 16 rows up to 128 within 256 threads
    # (two warps per 16 rows at Cout = 128), and 2 or 3 ring stages
    monkeypatch.setattr(sparse_conv_module, "_TF32_TILE_M", tile_m)
    g = torch.Generator(device=cuda_device).manual_seed(15)
    n, m = 2000, 1537
    feats = torch.randn(n, cin, device=cuda_device, generator=g)
    kernel = torch.randn(27 * cin, cout, device=cuda_device, generator=g) * 0.2
    idx = _tc_index(cuda_device, g, n, m, 27)
    out = sparse_conv(feats, kernel, idx)
    ref = sparse_conv_ref(feats, kernel, _missing_to_n(idx, n))
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("cin,cout,k", ENCODER_CONVS)
@pytest.mark.parametrize("mirror", [True, False])
def test_sparse_conv_dgrad_tf32_encoder_widths(cuda_device, cin, cout, k, mirror):
    # d_feats [N, Cin] from g [M, Cout]: mirrored taps over the forward index
    # (submanifold) or the transposed taps over an inverse index (strided)
    g = torch.Generator(device=cuda_device).manual_seed(11)
    n, m = 4037, 3000
    grad = torch.randn(m, cout, device=cuda_device, generator=g)
    w = torch.randn(k * cin, cout, device=cuda_device, generator=g) * 0.2
    bwd_idx = _tc_index(cuda_device, g, m, n, k)
    w_bwd = backward_kernel(w, k, mirror)
    before = (sparse_conv_dgrad.launches, sparse_conv_dgrad.tf32_launches)
    out = sparse_conv_dgrad(grad, w_bwd, bwd_idx)
    assert (sparse_conv_dgrad.launches, sparse_conv_dgrad.tf32_launches) == (
        before[0] + 1, before[1] + 1)
    ref = sparse_conv_ref(grad, w_bwd, _missing_to_n(bwd_idx, m))
    assert out.shape == (n, cin) and out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("cin,cout", [(4, 16), (16, 32), (64, 64)])
def test_sparse_conv_tf32_local_sorted_index(cuda_device, cin, cout):
    # a real submanifold index: the dgrad over the mirrored weights equals
    # the autograd of the plain forward
    idx, n = _local_index(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(12)
    feats = torch.randn(n, cin, device=cuda_device, generator=g).requires_grad_(True)
    kernel = torch.randn(27 * cin, cout, device=cuda_device, generator=g) * 0.2
    grad = torch.randn(n, cout, device=cuda_device, generator=g)
    (sparse_conv_ref(feats, kernel, idx) * grad).sum().backward()
    d_feats = sparse_conv_dgrad(grad, backward_kernel(kernel, 27, True), idx)
    assert (d_feats - feats.grad).abs().max().item() <= 1e-5 * feats.grad.abs().max().item()


@pytest.mark.parametrize("cin,cout,k", ENCODER_CONVS)
def test_sparse_conv_wgrad_tf32_encoder_widths(cuda_device, cin, cout, k):
    g = torch.Generator(device=cuda_device).manual_seed(13)
    n, m = 3000, 4037
    feats = torch.randn(n, cin, device=cuda_device, generator=g)
    grad = torch.randn(m, cout, device=cuda_device, generator=g)
    idx = _tc_index(cuda_device, g, n, m, k)
    before = (sparse_conv_wgrad.launches, sparse_conv_wgrad.tf32_launches)
    dw = sparse_conv_wgrad(feats, grad, idx)
    assert (sparse_conv_wgrad.launches, sparse_conv_wgrad.tf32_launches) == (
        before[0] + 1, before[1] + 1)
    ref = sparse_conv_wgrad_ref(feats, grad, _missing_to_n(idx, n))
    assert dw.shape == (k * cin, cout) and dw.dtype == torch.float32
    # float32 sums in another order: 1e-4 of scale
    assert (dw - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    # deterministic: fixed hit lists, fixed warp split, fixed-order reduce
    assert torch.equal(dw, sparse_conv_wgrad(feats, grad, idx))


def test_sparse_conv_tf32_non_finite_rows(cuda_device):
    # an Inf or NaN input row makes every output row that reads it non-finite
    # and touches no other row
    feats, _, idx = _conv_inputs(cuda_device, torch.float32, 500, 400, 16, 32, 27, seed=14)
    kernel = torch.randn(27 * 16, 32, device=cuda_device) * 0.2
    feats[7, 3], feats[9, 0] = float("inf"), float("nan")
    out = sparse_conv(feats, kernel, idx)
    reach = ((idx == 7) | (idx == 9)).any(1)
    assert reach.any() and not reach.all()
    assert (~torch.isfinite(out[reach])).any(1).all()
    clean = feats.clone()
    clean[7], clean[9] = 0.0, 0.0
    ref = sparse_conv_ref(clean, kernel, idx)
    assert torch.isfinite(out[~reach]).all()
    assert (out[~reach] - ref[~reach]).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_tensor_cores_reject_what_they_cannot_take(cuda_device):
    idx = torch.zeros(5, 27, dtype=torch.int32, device=cuda_device)
    bf = torch.bfloat16
    with pytest.raises(ValueError):  # 130 channels: padded to 136, past the widest instance
        sparse_conv(torch.zeros(10, 130, device=cuda_device, dtype=bf),
                    torch.zeros(27 * 130, 16, device=cuda_device, dtype=bf), idx)
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
    # a small shared-memory budget gives a short hit list (16 to 64 float32
    # hits), so each block stages and flushes it many times per tap
    monkeypatch.setattr(sparse_conv_module, "_TC_WGRAD_SMEM_BYTES", 4 * smem_floats)
    feats, grad, idx = _conv_inputs(cuda_device, torch.float32, 3000, 2500, cin, cout, 27, seed=3)
    dw = sparse_conv_wgrad(feats, grad, idx)
    ref = sparse_conv_wgrad_ref(feats, grad, idx)
    # float32 sums of the same products in another order: 1e-4 of scale
    assert (dw - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert torch.equal(dw, sparse_conv_wgrad(feats, grad, idx))


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
@pytest.mark.parametrize("n,c,m", [(512, 128, 256), (96, 3, 1001), (777, 72, 4099),
                                   (300, 36, 8193), (5000, 7, 300001), (64, 1, 5)])
def test_gather_elems_is_exact(cuda_device, dtype, n, c, m):
    # C not a multiple of the 16-byte vector (pieces cross row ends, output
    # bytes not a multiple of 16), misses of both signs, Inf, NaN, -0 and
    # subnormals as they are
    from robustpointclouds_tpu_torch.kernels import gather as gmod

    x, idx = _gather_inputs(cuda_device, dtype, n, c, m, seed=n + c + 1, specials=True)
    before = gmod.gather_elems.launches
    out = gmod.gather_elems(x, idx)
    again = gmod.gather_elems(x, idx)
    assert gmod.gather_elems.launches == before + 2
    ref = gmod.gather_ref(x, idx.masked_fill(idx < 0, n))
    assert torch.equal(_bits(out), _bits(ref)) and torch.equal(_bits(again), _bits(out))
    assert not _bits(out[:2]).any()  # the misses read +0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset,c", [(1, 16), (3, 16), (1, 5), (2, 64)])
def test_gather_elems_takes_unaligned_bases(cuda_device, dtype, offset, c):
    from robustpointclouds_tpu_torch.kernels import gather as gmod

    big, idx = _gather_inputs(cuda_device, dtype, 401, c, 3000, seed=8)
    x = big.view(-1)[offset:offset + 400 * c].view(400, c)  # a contiguous view off the base
    assert x.data_ptr() % 16
    assert gmod.elem_plan(3000, c, x.element_size(), gmod._align(x)).piece < 16
    out = gmod.gather_elems(x, idx)
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
    for fn in (gmod.gather_elems, gmod.gather_row_loop, gmod.gather_onehot):
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

    elems = gmod._fn("rpc_gather_elems")
    args = (xs.data_ptr(), idx.data_ptr(), out.data_ptr(), 4, 9)
    assert elems(*args, plan(8, 4, *gmod.elem_plan(4, 8, 4, 4)), stream) == 0
    assert elems(*args, plan(8, 4, 16, 4, 1), stream) != 0  # 16-byte pieces off the base
    assert elems(*args, plan(8, 4, 4, 5, 1), stream) != 0  # 5 vectors a thread
    assert elems(*args, plan(8, 4, 4, 0, 1), stream) != 0  # none
    assert elems(*args, plan(8, 4, 4, 4, 2), stream) != 0  # a grid that disagrees
    assert elems(*args, plan(8, 3, 4, 4, 1), stream) != 0  # 3-byte elements
    row_loop, onehot = gmod._fn("rpc_gather_row_loop"), gmod._fn("rpc_gather_onehot")
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


def _small_f32_trainer(dev, monkeypatch, cfg=None, **train_kw):
    """A float32 trainer on the 16 m smoke grid at real widths (PERT_BF16 off)."""
    import robustpointclouds_tpu_torch.nn.perturber as perturber
    from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg
    from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

    monkeypatch.setattr(perturber, "PERT_BF16", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = cfg or tiny_voxelnet_cfg()._replace(compute_dtype="float32")
    return Trainer(cfg, TrainConfig(**train_kw), device=dev)


def _small_batch(cfg):
    import numpy as np

    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch

    return synthetic_kitti_batch(np.random.RandomState(2), batch_size=2, num_points=600, max_gt=8,
                                 num_objects=3, point_range=cfg.voxelizer.point_cloud_range)


def _separated_cars(seed=5, n=512, max_gt=8):
    """The PGD-AT setup of tests/test_attacks.py (tests/test_attack_quantified's
    separated_car_batch): 2 frames of 6 Cars on a grid >= 4.5 m apart."""
    import numpy as np

    from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch

    rng = np.random.RandomState(seed)
    car = np.array([3.9, 1.6, 1.56], np.float32)
    yaws = [0.0, 0.3, -0.3, 0.15, -0.15, 0.25]
    points = np.zeros((2, n, 4), np.float32)
    boxes = np.zeros((2, max_gt, 7), np.float32)
    gt_mask = np.zeros((2, max_gt), bool)
    for b in range(2):
        centres = [(x, y) for x in (5.5, 10.5) for y in (-4.5, 0.0, 4.5)]
        for i, (x, y) in enumerate(centres):
            boxes[b, i] = [x, y, -0.6, *car, yaws[i]]
            gt_mask[b, i] = True
        per, idx = int(n * 0.8) // len(centres), 0
        for i in range(len(centres)):
            local = rng.uniform(-0.45, 0.45, (per, 3)).astype(np.float32) * car
            c, s = np.cos(yaws[i]), np.sin(yaws[i])
            world = local.copy()
            world[:, 0] = local[:, 0] * c - local[:, 1] * s
            world[:, 1] = local[:, 0] * s + local[:, 1] * c
            points[b, idx:idx + per, :3] = world + boxes[b, i, :3]
            idx += per
        nbg = n - idx
        points[b, idx:, :3] = np.stack([rng.uniform(0.5, 15.5, nbg), rng.uniform(-7.5, 7.5, nbg),
                                        rng.uniform(-1.9, -1.6, nbg)], axis=1)
        points[b, :, 3] = rng.uniform(0, 1, n)
    return PointCloudBatch(points, np.ones((2, n), bool), boxes,
                           np.zeros((2, max_gt), np.int32), gt_mask)


# float32 train-step gradients card vs CPU (chip_smoke.py's small-grid bound):
# summation order; tensors whose true gradient is 0 held to 1e-6 of the largest
TRAIN_GRAD_RTOL, TRAIN_GRAD_FLOOR = 1e-3, 1e-6
# a ReLU-fused BatchNorm's output card vs CPU, relative to its largest entry
# (17 outputs of the small-grid step: at most 2.7e-6 on the H100)
BN_OUT_RTOL = 1e-5


def _assert_grads_close(gc, gg):
    gmax = max(v.abs().max().item() for v in gc.values())
    for n, ref in gc.items():
        scale = max(ref.abs().max().item(), TRAIN_GRAD_FLOOR * gmax / TRAIN_GRAD_RTOL)
        assert (gg[n] - ref).abs().max().item() <= TRAIN_GRAD_RTOL * scale, n


def _pgd_on_both_sides(cuda_device, monkeypatch, cfg, b, k):
    """CPU and card trainers from the same weights, each attacking the same
    host plan by k PGD steps; the attacked voxels held to each other."""
    from robustpointclouds_tpu_torch.nn.perturber import _bound_profile

    sides, sd = [], None
    for dev in (torch.device("cpu"), cuda_device):
        tr = _small_f32_trainer(dev, monkeypatch, cfg, pgd_steps=k)
        tr.init_state(0, state_dict=sd)
        sd = sd or {n: v.cpu() for n, v in tr.model.state_dict().items()}
        plan = tr.make_plan_builder()(b.points, b.points_mask, b.gt_boxes, b.gt_labels, b.gt_mask)
        gt, plan_d = tr._to_device(b, plan)
        sides.append((tr, plan, tr._maybe_pgd(b, plan_d)["voxels"].cpu()))
    (cpu_tr, plan, v_cpu), (card_tr, _, v_card) = sides
    # the attack: sign(g) may flip where |g| is at rounding level
    _, clamp = _bound_profile(4, 0.2, attack=True)
    alpha = torch.as_tensor(2.5 * clamp / k, dtype=torch.float32)
    assert (v_card == v_cpu).float().mean().item() >= 0.99
    assert ((v_card - v_cpu).abs() <= 2 * alpha + 1e-5).all()
    return cpu_tr, card_tr, plan, v_card


def _loosened_iou(cfg):
    """The loosened IoU thresholds of tests/test_torch_pgd_train.py: the
    separated cars' anchors become positives."""
    return cfg._replace(head=cfg.head._replace(
        pos_iou_thr=(0.25, 0.1, 0.1), neg_iou_thr=(0.15, 0.05, 0.05),
        min_pos_iou=(0.1, 0.05, 0.05)))


@pytest.mark.parametrize("adversary", [False, True], ids=["no_adversary", "learned_adversary"])
def test_pgd_train_step_on_card_matches_cpu(cuda_device, monkeypatch, adversary):
    """PGD-AT on the separated cars with the loosened IoU thresholds (real
    positives), without the learned adversary (the setup of
    tests/test_torch_pgd_train.py) and with it (the default config's)."""
    from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg

    k = 2
    cfg = _loosened_iou(tiny_voxelnet_cfg()._replace(compute_dtype="float32"))
    if not adversary:
        cfg = cfg._replace(adversary=None)
    b = _separated_cars()
    cpu_tr, card_tr, plan, v_card = _pgd_on_both_sides(cuda_device, monkeypatch, cfg, b, k)
    # the gradient half of the PGD-AT step on the card's attacked plan, both sides
    grads = []
    for tr in (cpu_tr, card_tr):
        gt, plan_d = tr._to_device(b, dict(plan, voxels=v_card.numpy()))
        g, logs, is_nan = tr._grads(gt, 5.0, plan_d)
        assert not bool(is_nan) and float(logs["num_pos"]) > 1
        grads.append({n: v.cpu() for n, v in g.items()})
    _assert_grads_close(*grads)
    # and the whole step on the card runs the attack (no weight gradient), then trains
    before = (sparse_conv.launches, sparse_conv_wgrad.launches)
    card_tr.train_step(b, 5, plan)
    torch.cuda.synchronize()
    assert (sparse_conv.launches - before[0], sparse_conv_wgrad.launches - before[1]) == (
        12 * (k + 1), 12)
    assert all(p.requires_grad for p in card_tr.model.parameters())


def test_pgd_train_step_card_vs_cpu_gap_is_a_relu_kink(cuda_device, monkeypatch):
    """The learned adversary on the seed-2 small batch (one positive), its
    gradients on the card's attacked voxels. There the card and the CPU
    round one ReLU's input (encoder_layer3.2's BN, row 179, channel 15) to
    opposite sides of 0 (-1.8e-7 / +3.5e-7, depending on the CPU), and the
    gradient of that layer's conv weight jumps by 3e-2 of its scale, past
    the bound. This test finds every such unit and shows that it explains
    the gap: each ReLU-fused BatchNorm's output agrees card vs CPU within
    BN_OUT_RTOL, every unit whose gate differs has an input within that
    rounding band of 0, and with the CPU's gates set to the card's (its
    output there its input times the card's gate) the gradients agree at the
    bound."""
    from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg
    from robustpointclouds_tpu_torch.nn.layers import MaskedBatchNorm

    k = 2
    cfg = tiny_voxelnet_cfg()._replace(compute_dtype="float32")
    b = _small_batch(cfg)
    cpu_tr, card_tr, plan, v_card = _pgd_on_both_sides(cuda_device, monkeypatch, cfg, b, k)
    card_out, cpu_in, card_at = {}, {}, {}
    forward = MaskedBatchNorm.forward

    def gated(self, x, mask, relu=False, row_mask=False, out_dtype=None):
        if relu and self in card_at:  # CPU: the ReLU's input times the card's gate
            y = forward(self, x, mask, relu=False, row_mask=row_mask, out_dtype=out_dtype)
            cpu_in[self] = y.detach()
            return y * (card_at[self] > 0)
        out = forward(self, x, mask, relu=relu, row_mask=row_mask, out_dtype=out_dtype)
        if relu and out.is_cuda:
            card_out[self] = out.detach().cpu()
        return out

    monkeypatch.setattr(MaskedBatchNorm, "forward", gated)
    grads = []
    for tr in (card_tr, cpu_tr):
        if tr is cpu_tr:  # the card's ReLU outputs by the CPU's modules
            card_mods = dict(card_tr.model.named_modules())
            card_at.update((m, card_out[card_mods[n]]) for n, m in cpu_tr.model.named_modules()
                           if card_mods[n] in card_out)
            assert len(card_at) == 17  # the encoder's 12 and the adversary's 5
        gt, plan_d = tr._to_device(b, dict(plan, voxels=v_card.numpy()))
        g, logs, is_nan = tr._grads(gt, 5.0, plan_d)
        assert not bool(is_nan) and float(logs["num_pos"]) > 0
        grads.append({n: v.cpu() for n, v in g.items()})
    for m, card in card_at.items():
        y = cpu_in[m]
        band = BN_OUT_RTOL * card.abs().max().item()
        assert (y.clamp(min=0) - card).abs().max().item() <= band
        flipped = (y > 0) != (card > 0)
        assert (y[flipped].abs() <= band).all()
    gg, gc = grads
    _assert_grads_close(gc, gg)


def test_freeze_detector_on_card_keeps_the_detector(cuda_device, monkeypatch):
    tr = _small_f32_trainer(cuda_device, monkeypatch, freeze_detector=True, adversary_lr_mult=20.0)
    tr.init_state(0)
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    b = _small_batch(tr.model_cfg)
    builder = tr.make_plan_builder()
    for _ in range(3):
        tr.train_step(b, 5, builder(b.points, b.points_mask, b.gt_boxes, b.gt_labels, b.gt_mask))
    torch.cuda.synchronize()
    moved = []
    for n, p in tr.model.named_parameters():
        same = torch.equal(p.detach().view(torch.int32), before[n].view(torch.int32))
        if n.startswith("adversary."):
            moved.append(not same)
        else:
            assert same, n
    assert any(moved) and tr.state.count == 3


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


# the strong adversary's 256-wide BatchNorms (enc_bn_2, dec_bn_1) at B = 1 and B = 6
STRONG_ROWS = [16000, 96000]


@pytest.mark.parametrize("n", STRONG_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_five_masked_kernels_at_c256(cuda_device, n, dtype):
    """Statistics, fused forward (train, ReLU, no row mask: the perturber's
    epilogue), bwd_reduce + dx, and the statistics' VJP at C = 256 against
    the plain versions, each repeat bit-identical; each kernel counts its
    launches at C = 256 in KERNEL_LAUNCHES."""
    x, mask, w, b, rm, rv, gout = _bn_inputs(cuda_device, n, 256, dtype, seed=n)
    counted = masked_stats_module.KERNEL_LAUNCHES
    before = {k: counted[k, 256] for k in ("stats_kernel", "apply_kernel", "bwd_reduce_kernel",
                                           "dx_kernel", "vjp_kernel")}
    mean, var, cnt = masked_stats(x, mask)
    rmean, rvar, rcnt = masked_stats_ref(x, mask)
    assert cnt.item() == rcnt.item() and _close(mean, rmean, 1e-5) and _close(var, rvar, 1e-4)
    rm_ref, rv_ref = rm.clone(), rv.clone()
    y, bmean, bvar, bcnt = masked_stats_module._bn_forward(x, mask, w, b, rm, rv, True, 0.1,
                                                           1e-3, True, False, dtype)
    ref = masked_stats_module._bn_ref(x, mask, w, b, rm_ref, rv_ref, True, 0.1, 1e-3, True,
                                      False, dtype)[0]
    assert _close(y, ref, 1e-5 if dtype == torch.float32 else 1e-2)
    assert _close(rm, rm_ref, 1e-5) and _close(rv, rv_ref, 1e-5)
    dx, dw, db = masked_batch_norm_bwd(gout, x, mask, w, b, bmean, bvar, bcnt, 1e-3, True, True,
                                       False)
    rdx, rdw, rdb = masked_batch_norm_bwd_ref(gout, x, mask, w, b, bmean, bvar, bcnt, 1e-3, True,
                                              True, False)
    assert _close(dw, rdw, 1e-4) and _close(db, rdb, 1e-4)
    assert _close(dx, rdx, 1e-4 if dtype == torch.float32 else 1e-2)
    gm, gv = w - 1.0, b
    vjp = masked_stats_bwd(x, mask, mean, cnt, gm, gv)
    assert _close(vjp, masked_stats_bwd_ref(x, mask, mean, cnt, gm, gv),
                  1e-5 if dtype == torch.float32 else 1e-2)
    assert {k: counted[k, 256] - n for k, n in before.items()} == {
        "stats_kernel": 2, "apply_kernel": 1, "bwd_reduce_kernel": 1, "dx_kernel": 1,
        "vjp_kernel": 1}
    again = (masked_stats(x, mask),
             masked_stats_module._bn_forward(x, mask, w, b, rm.clone(), rv.clone(), True, 0.1,
                                             1e-3, True, False, dtype)[0],
             masked_batch_norm_bwd(gout, x, mask, w, b, bmean, bvar, bcnt, 1e-3, True, True,
                                   False),
             masked_stats_bwd(x, mask, mean, cnt, gm, gv))
    first = ((mean, var, cnt), y, (dx, dw, db), vjp)
    assert torch.equal(again[1], first[1]) and torch.equal(again[3], first[3])
    for p, q in ((again[0], first[0]), (again[2], first[2])):
        assert all(torch.equal(u, v) for u, v in zip(p, q))


def test_masked_kernels_keep_widths_4_to_128_bit_for_bit(cuda_device, tmp_path, monkeypatch):
    """csrc/masked_stats.cu built as it is and with kMaxC = 128 (the
    128-wide kernels it grew from): at every width up to 128, both types,
    each of the five kernels gives bit-identical results."""
    import subprocess

    from robustpointclouds_tpu_torch.kernels import _build

    src = open(os.path.join(_build.CSRC_DIR, "masked_stats.cu")).read()
    assert src.count("constexpr int kMaxC = 256;") == 1
    cu = tmp_path / "masked_stats_128.cu"
    cu.write_text(src.replace("constexpr int kMaxC = 256;", "constexpr int kMaxC = 128;"))
    so = tmp_path / "libmasked_stats_128.so"
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(so), str(cu)], check=True)
    narrow = masked_stats_module.bind(ctypes.CDLL(str(so)))
    wide = masked_stats_module.bind(_build.load_library("masked_stats"))

    def run(fns, x, mask, w, b, rm, rv, gout, relu, row_mask, train):
        monkeypatch.setattr(masked_stats_module, "_FNS", fns)
        rm, rv = rm.clone(), rv.clone()
        mean, var, cnt = masked_stats(x, mask)
        y, bm, bv, bc = masked_stats_module._bn_forward(x, mask, w, b, rm, rv, train, 0.1, 1e-3,
                                                        relu, row_mask, x.dtype)
        bwd = masked_batch_norm_bwd(gout, x, mask, w, b, bm, bv, bc, 1e-3, train, relu, row_mask)
        vjp = masked_stats_bwd(x, mask, mean, cnt, w, b)
        return [mean, var, cnt, y, rm, rv, *bwd, vjp]

    for c in masked_stats_module.WIDTHS[:-1]:
        for dtype in (torch.float32, torch.bfloat16):
            inputs = _bn_inputs(cuda_device, 20011, c, dtype, seed=c)
            for relu, row_mask in EPILOGUES:
                for train in (True, False):
                    got = run(wide, *inputs, relu, row_mask, train)
                    ref = run(narrow, *inputs, relu, row_mask, train)
                    for i, (u, v) in enumerate(zip(got, ref)):
                        assert torch.equal(u, v), (c, dtype, relu, row_mask, train, i)


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
    with pytest.raises(ValueError):  # not [N, C]
        masked_stats(torch.zeros(10, 2, 4, device=dev), mask)
    with pytest.raises(ValueError):  # 12 channels: not a width of the fused BatchNorm
        masked_batch_norm(torch.zeros(10, 12, device=dev), mask, w, b, torch.zeros(12, device=dev),
                          torch.ones(12, device=dev), True)
    with pytest.raises(ValueError):  # float16
        masked_stats(torch.zeros(10, 16, device=dev, dtype=torch.float16), mask)
    with pytest.raises(ValueError):  # wider than the kernels' 256
        masked_stats(torch.zeros(10, 512, device=dev), mask)
    with pytest.raises(ValueError):  # the mask on another device
        masked_stats(torch.zeros(10, 16, device=dev), mask.cpu())
    with pytest.raises(ValueError):  # a base 4 bytes past a 16-byte boundary
        masked_stats(torch.zeros(41, device=dev)[1:].view(10, 4), mask)
    with pytest.raises(ValueError):  # not contiguous
        masked_stats(torch.zeros(10, 32, device=dev)[:, ::2], mask)


# ---- CenterPoint's widths: K1 at Cin = 5 (zero-padded to 8 by the wrapper)
# and at 128 -> 128, K2 at C = 5, and a float32 CenterPoint train step

# (Cin, Cout, K) of the CenterPoint encoder's convs that SECOND's do not cover
CENTERPOINT_CONVS = [(5, 16, 27), (64, 128, 27), (128, 128, 27), (128, 128, 3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("cin,cout,k", CENTERPOINT_CONVS)
def test_sparse_conv_centerpoint_widths(cuda_device, dtype, cin, cout, k):
    """Forward, dgrad (d_feats of Cin columns: 5 for conv_input) and wgrad
    against the plain versions, each one counted launch, the float32 ones
    on the 3xTF32 kernels; the bf16 bound is one output rounding, the
    float32 ones those of the SECOND widths' tests."""
    g = torch.Generator(device=cuda_device).manual_seed(cin + cout + k)
    n, m = 3000, 4037
    feats = torch.randn(n, cin, device=cuda_device, generator=g).to(dtype)
    kernel = (torch.randn(k * cin, cout, device=cuda_device, generator=g) * 0.2).to(dtype)
    grad = torch.randn(m, cout, device=cuda_device, generator=g).to(dtype)
    idx = _tc_index(cuda_device, g, n, m, k)
    bwd_idx = _tc_index(cuda_device, g, m, n, k)
    f32 = int(dtype == torch.float32)
    fns = (sparse_conv, sparse_conv_dgrad, sparse_conv_wgrad)
    before = [(fn.launches, fn.tf32_launches) for fn in fns]
    out = sparse_conv(feats, kernel, idx)
    w_bwd = backward_kernel(kernel, k, k == 27)
    d = sparse_conv_dgrad(grad, w_bwd, bwd_idx)
    dw = sparse_conv_wgrad(feats, grad, idx)
    assert [(fn.launches - a, fn.tf32_launches - b) for fn, (a, b) in zip(fns, before)] == [
        (1, f32)] * 3
    tol = 1e-5 if f32 else 1e-2
    for got, ref in ((out, sparse_conv_ref(feats, kernel, _missing_to_n(idx, n))),
                     (d, sparse_conv_ref(grad, w_bwd, _missing_to_n(bwd_idx, m)))):
        assert got.shape == ref.shape and got.dtype == dtype
        assert (got.float() - ref.float()).abs().max().item() <= tol * ref.float().abs().max().item()
    ref = sparse_conv_wgrad_ref(feats, grad, _missing_to_n(idx, n))
    assert dw.shape == (k * cin, cout) and dw.dtype == torch.float32
    assert (dw - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert torch.equal(dw, sparse_conv_wgrad(feats, grad, idx))
    assert out[64:128].abs().max().item() == 0.0  # the tile that misses every tap


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_sparse_conv_function_at_cin5_on_card_matches_cpu(cuda_device, dtype):
    """conv_input's autograd Function (forward, mirrored dgrad, wgrad) on a
    real submanifold index, card against CPU."""
    idx, n = _local_index(cuda_device)
    g = torch.Generator().manual_seed(21)
    feats = torch.randn(n, 5, generator=g).to(dtype)
    weight = torch.randn(27 * 5, 16, generator=g) * 0.2
    grad = torch.randn(n, 16, generator=g).to(dtype)
    res = []
    for dev in (torch.device("cpu"), cuda_device):
        f = feats.detach().to(dev).requires_grad_(True)
        w = weight.detach().to(dev).requires_grad_(True)
        out = sparse_conv_train(f, w, idx.to(dev), idx.to(dev), True)
        out.backward(grad.to(dev))
        res.append([t.float().cpu() for t in (out, f.grad, w.grad)])
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for c, k in zip(*res):
        assert (k - c).abs().max().item() <= tol * c.abs().max().item()


@pytest.mark.parametrize("n", [2_400_000, 300001, 1])
def test_masked_stats_at_c5_pads_exactly(cuda_device, n):
    """The CenterPoint adversary's statistics of [N, 5] float32 point
    features and their VJP: one launch each, the plain versions' values,
    bit-identical repeats (the statistics merge in a fixed order)."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(n, 5, device=cuda_device, generator=g) * torch.tensor(
        [20.0, 20.0, 1.0, 0.3, 0.0], device=cuda_device)
    mask = torch.rand(n, device=cuda_device, generator=g) > 0.3
    mask[0] = True
    before = (masked_stats.launches, masked_stats_bwd.launches)
    mean, var, cnt = masked_stats(x, mask)
    rm, rv, rc = masked_stats_ref(x, mask)
    assert mean.shape == var.shape == (5,) and cnt.item() == rc.item()
    torch.testing.assert_close(mean, rm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(var, rv, rtol=1e-4, atol=1e-4)
    m2, v2, c2 = masked_stats(x, mask)
    assert torch.equal(m2, mean) and torch.equal(v2, var) and torch.equal(c2, cnt)
    gm = torch.randn(5, device=cuda_device, generator=g)
    gv = torch.randn(5, device=cuda_device, generator=g)
    dx = masked_stats_bwd(x, mask, mean, cnt, gm, gv)
    ref = masked_stats_bwd_ref(x, mask, mean, cnt, gm, gv)
    assert dx.shape == (n, 5) and (dx - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert torch.equal(dx, masked_stats_bwd(x, mask, mean, cnt, gm, gv))
    assert (masked_stats.launches - before[0], masked_stats_bwd.launches - before[1]) == (2, 2)


def _centerpoint_small_f32(dev, monkeypatch):
    import numpy as np

    import robustpointclouds_tpu_torch.nn.perturber as perturber
    from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
    from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
    from robustpointclouds_tpu_torch.models.centerpoint import CenterPointConfig
    from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer

    monkeypatch.setattr(perturber, "PERT_BF16", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, n_pts = tiny_centerpoint_cfg(CenterPointConfig(compute_dtype="float32"))
    b, vel = synthetic_nuscenes_batch(np.random.RandomState(3), batch_size=2, num_points=n_pts,
                                      max_gt=cfg.head.max_objs, num_objects=6,
                                      point_range=cfg.voxelizer.point_cloud_range)
    return CenterPointTrainer(cfg, device=dev), b, vel


def _bn2d_outputs_and_flips(model, flips=None):
    """Hooks on the dense body's BatchNorms (each followed by a ReLU): record
    their outputs and, for the units in `flips`, negate the value (the
    gradient passing as before) so that those ReLU gates take the other side."""
    from robustpointclouds_tpu_torch.nn.second import BatchNorm2d

    seen, hooks = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm2d):
            def hook(m, inp, out, name=name):
                seen[name] = out.detach().cpu()
                if flips and name in flips:
                    f = flips[name].to(out.device)
                    return out + torch.where(f, -2 * out, 0 * out).detach()
            hooks.append(mod.register_forward_hook(hook))
    return seen, hooks


@pytest.mark.parametrize("epoch", [5, 0])
def test_centerpoint_train_step_on_card_matches_cpu(cuda_device, monkeypatch, epoch):
    """The tiny_centerpoint_cfg float32 train step (epoch 5: the adversary
    on), card against CPU from the same weights and plan, at the small-grid
    bound of the SECOND step. A ReLU input that the two sides round to
    opposite signs must lie within BN_OUT_RTOL of its BatchNorm's scale, and
    is then aligned (the CPU's gate set to the card's), as the PGD-AT test
    does; the step's launches are the module structure's."""
    cpu_tr, b, vel = _centerpoint_small_f32(torch.device("cpu"), monkeypatch)
    card_tr, _, _ = _centerpoint_small_f32(cuda_device, monkeypatch)
    cpu_tr.init_state(0)
    sd = {n: v.cpu() for n, v in cpu_tr.model.state_dict().items()}
    card_tr.init_state(0, state_dict=sd)
    plan = cpu_tr.make_plan_builder()(b.points, b.points_mask, b.gt_boxes, b.gt_labels,
                                      b.gt_mask, vel)
    from robustpointclouds_tpu_torch.models.voxelnet import plan_to_device

    def grads(tr, flips=None):
        tr.init_state(0, state_dict=sd)
        seen, hooks = _bn2d_outputs_and_flips(tr.model, flips)
        try:
            g, logs, is_nan = tr._grads(None, float(epoch), plan_to_device(plan, tr.device))
        finally:
            for h in hooks:
                h.remove()
        assert not bool(is_nan)
        return {n: v.cpu() for n, v in g.items()}, seen

    counters = (sparse_conv, sparse_conv_dgrad, sparse_conv_wgrad, masked_stats, masked_stats_bwd,
                masked_batch_norm, masked_batch_norm_bwd)
    before = [fn.launches for fn in counters]
    gg, card_bn = grads(card_tr)
    torch.cuda.synchronize()
    launched = [fn.launches - n for fn, n in zip(counters, before)]
    # 21 sparse convs (forward, dgrad, wgrad: the input needs its gradient, the
    # adversary being in the graph, gated, at every epoch); the adversary's
    # statistics: 2 (std, regulariser), no VJP (the regulariser's per-dim
    # statistics feed the bias and imbalance terms, which CenterPoint's
    # objective leaves out); BNs: 21 encoder + 5 adversary
    assert launched == [21, 21, 21, 2, 0, 26, 26], launched
    gc, cpu_bn = grads(cpu_tr)
    flips = {}
    for k, card in card_bn.items():
        differ = (card > 0) != (cpu_bn[k] > 0)
        if differ.any():
            assert card[differ].abs().max().item() <= BN_OUT_RTOL * card.abs().max().item(), k
            flips[k] = differ
    if flips:
        gc, _ = grads(cpu_tr, flips)
    _assert_grads_close(gc, gg)


# the pillar family's K2 shapes: B * V * T = 6 * 16000 * 32 point slots, of
# which a KITTI-like frame fills ~3.5%
PILLAR_SLOTS = 6 * 16000 * 32


@pytest.mark.parametrize("c,dtype", [(64, torch.bfloat16), (128, torch.float32)],
                         ids=["pfn_bf16", "f32"])
def test_masked_batch_norm_at_pillar_rows(cuda_device, c, dtype):
    """The fused MaskedBatchNorm (train mode, ReLU, no row mask: the PFN's
    and the perturber's epilogue) and its backward at the pillar slots
    against the plain versions; [3072000, 128] float32 is x of 1.57 GB,
    past 2^31 bytes, so every row offset must be 64-bit."""
    n = PILLAR_SLOTS
    g = torch.Generator(device=cuda_device).manual_seed(c)
    x = (torch.randn(n, c, device=cuda_device, generator=g) * 3 + 1).to(dtype)
    mask = torch.rand(n, device=cuda_device, generator=g) < 0.035
    mask[-1000:] = True  # the last rows, past 2^31 bytes for float32
    w = 0.5 + torch.rand(c, device=cuda_device, generator=g)
    b = torch.randn(c, device=cuda_device, generator=g)
    rm, rv = torch.zeros(c, device=cuda_device), torch.ones(c, device=cuda_device)
    gout = torch.randn(n, c, device=cuda_device, generator=g).to(dtype)
    rm_ref, rv_ref = rm.clone(), rv.clone()
    y, mean, var, cnt = masked_stats_module._bn_forward(x, mask, w, b, rm, rv, True, 0.01, 1e-3,
                                                        True, False, dtype)
    ref, _, _, rcnt = masked_stats_module._bn_ref(x, mask, w, b, rm_ref, rv_ref, True, 0.01,
                                                  1e-3, True, False, dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _close(y, ref, tol) and cnt.item() == rcnt.item() == mask.sum().item()
    assert _close(y[-1000:], ref[-1000:], tol)
    assert _close(rm, rm_ref, 1e-5) and _close(rv, rv_ref, 1e-5)
    dx, dw, db = masked_batch_norm_bwd(gout, x, mask, w, b, mean, var, cnt, 1e-3, True, True,
                                       False)
    rdx, rdw, rdb = masked_batch_norm_bwd_ref(gout, x, mask, w, b, mean, var, cnt, 1e-3, True,
                                              True, False)
    assert _close(dw, rdw, 1e-4) and _close(db, rdb, 1e-4)
    assert _close(dx, rdx, 1e-4 if dtype == torch.float32 else 1e-2)
    assert _close(dx[-1000:], rdx[-1000:], 1e-4 if dtype == torch.float32 else 1e-2)
    again = masked_batch_norm_bwd(gout, x, mask, w, b, mean, var, cnt, 1e-3, True, True, False)
    assert all(torch.equal(p, q) for p, q in zip(again, (dx, dw, db)))


def test_pillar_train_step_on_card_matches_cpu(cuda_device, monkeypatch):
    """The tiny pillar config's float32 train step at epoch 5 (the adversary
    on), card against CPU from the same weights and plan, at the small-grid
    bound of the SECOND step, with the dense body's rounding-level ReLU
    gates aligned as the CenterPoint test does; the step's launches are the
    module structure's: no sparse conv, the adversary's 2 statistics and
    their VJP, 6 fused BNs (the PFN's and the adversary's 5) with bwd_reduce."""
    import numpy as np

    import robustpointclouds_tpu_torch.nn.perturber as perturber
    from robustpointclouds_tpu_torch.cli.common import tiny_pointpillars_cfg
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
    from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

    monkeypatch.setattr(perturber, "PERT_BF16", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = tiny_pointpillars_cfg()._replace(compute_dtype="float32")
    b = synthetic_kitti_batch(np.random.RandomState(2), batch_size=2, num_points=512, max_gt=8,
                              num_objects=3, point_range=cfg.voxelizer.point_cloud_range)
    cpu_tr = Trainer(cfg, TrainConfig(), device="cpu")
    card_tr = Trainer(cfg, TrainConfig(), device=cuda_device)
    cpu_tr.init_state(0)
    sd = {n: v.cpu() for n, v in cpu_tr.model.state_dict().items()}
    plan = cpu_tr.make_plan_builder()(b.points, b.points_mask, b.gt_boxes, b.gt_labels, b.gt_mask)

    def grads(tr, flips=None):
        tr.init_state(0, state_dict=sd)
        seen, hooks = _bn2d_outputs_and_flips(tr.model, flips)
        try:
            gt, plan_t = tr._to_device(b, plan)
            g, logs, is_nan = tr._grads(gt, 5.0, plan_t)
        finally:
            for h in hooks:
                h.remove()
        assert not bool(is_nan) and float(logs["num_pos"]) > 0
        return {n: v.cpu() for n, v in g.items()}, seen

    counters = (sparse_conv, sparse_conv_dgrad, sparse_conv_wgrad, masked_stats, masked_stats_bwd,
                masked_batch_norm, masked_batch_norm_bwd)
    before = [fn.launches for fn in counters] + [masked_batch_norm_bwd.reduce_launches]
    gg, card_bn = grads(card_tr)
    torch.cuda.synchronize()
    launched = [fn.launches - n for fn, n in zip(counters, before[:-1])]
    launched.append(masked_batch_norm_bwd.reduce_launches - before[-1])
    assert launched == [0, 0, 0, 2, 1, 6, 6, 6], launched
    gc, cpu_bn = grads(cpu_tr)
    flips = {}
    for k, card in card_bn.items():
        differ = (card > 0) != (cpu_bn[k] > 0)
        if differ.any():
            assert card[differ].abs().max().item() <= BN_OUT_RTOL * card.abs().max().item(), k
            flips[k] = differ
    if flips:
        gc, _ = grads(cpu_tr, flips)
    _assert_grads_close(gc, gg)


def _plan_mismatches(card, host, path=""):
    """Paths where the card's plan (tensors) differs from the host's (numpy)."""
    if isinstance(host, dict):
        assert sorted(card) == sorted(host), path
        return [p for k in host for p in _plan_mismatches(card[k], host[k], f"{path}/{k}")]
    h = torch.from_numpy(host)
    c = card.cpu()
    if c.dtype != h.dtype or c.shape != h.shape or not torch.equal(c, h):
        return [path]
    return []


@pytest.mark.parametrize("family,seed", [("second", 0), ("second_truncating", 5),
                                         ("pillars", 1)])
def test_inline_plan_on_the_card_equals_the_native_plan(cuda_device, family, seed):
    """The inline path's plan built on the card (torch sorts, scans, scatters
    and searches there) holds every array of the native host plan of the
    same points, dtypes included, at the smoke grids (the truncating case
    caps voxels, slots and downsample sites)."""
    import numpy as np

    from robustpointclouds_tpu_torch.cli.common import tiny_pointpillars_cfg, tiny_voxelnet_cfg
    from robustpointclouds_tpu_torch.data.native_plan import (build_pillar_plan_native,
                                                              build_plan_native)
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
    from robustpointclouds_tpu_torch.models import pointpillars, voxelnet
    from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig

    if family == "pillars":
        cfg = tiny_pointpillars_cfg()
        build, build_host = pointpillars.build_pillar_plan, build_pillar_plan_native
    else:
        cfg = tiny_voxelnet_cfg()
        if family == "second_truncating":
            cfg = cfg._replace(voxelizer=VoxelizerConfig(
                (0.0, -8.0, -3.0, 16.0, 8.0, 1.0), (0.25, 0.25, 0.125), 2, 128))
        build, build_host = voxelnet.build_plan, build_plan_native
    b = synthetic_kitti_batch(np.random.RandomState(seed), batch_size=3, num_points=4000,
                              max_gt=8, num_objects=3, point_range=cfg.voxelizer.point_cloud_range)
    pts, msk = np.asarray(b.points), np.asarray(b.points_mask)
    host = build_host(pts, msk, cfg.voxelizer, 4)
    card = build(torch.from_numpy(pts).to(cuda_device), torch.from_numpy(msk).to(cuda_device),
                 cfg)
    assert card["voxels"].is_cuda
    assert _plan_mismatches(card, host) == []


# ---- the serving export: K1's forward and K2's apply as torch.library
# operators (rpc::sparse_conv_fwd, rpc::masked_bn_apply), and an exported
# program that launches them

@pytest.mark.parametrize("dtype,cin,cout,k", [(torch.bfloat16, 16, 32, 27),
                                              (torch.bfloat16, 5, 16, 27),
                                              (torch.float32, 64, 128, 3),
                                              (torch.float32, 5, 16, 27)])
def test_sparse_conv_operator_is_the_direct_launch(cuda_device, dtype, cin, cout, k):
    """The operator's output is bit-equal to its CUDA version called
    directly (the kernel launch behind it), and opcheck passes on the card."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    n, m = 3000, 2500
    feats = torch.randn(n, cin, device=cuda_device, generator=g).to(dtype)
    kernel = (torch.randn(k * cin, cout, device=cuda_device, generator=g) * 0.2).to(dtype)
    idx = _tc_index(cuda_device, g, n, m, k)
    direct = sparse_conv_module._sparse_conv_fwd_cuda(feats, kernel, idx)
    before = (sparse_conv.launches, sparse_conv.tf32_launches)
    got = sparse_conv_module.sparse_conv_fwd(feats, kernel, idx)
    assert (sparse_conv.launches - before[0], sparse_conv.tf32_launches - before[1]) == (
        1, int(dtype == torch.float32))
    assert got.dtype == dtype and torch.equal(got, direct)
    torch.library.opcheck(sparse_conv_module.sparse_conv_fwd, (feats, kernel, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [True, False])
def test_masked_bn_apply_operator_is_the_direct_launch(cuda_device, dtype, train):
    """The apply operator, on a train-mode BN's batch statistics or on
    running statistics, is bit-equal to its CUDA version called directly;
    opcheck passes on the card."""
    x, mask, w, b, rm, rv, _ = _bn_inputs(cuda_device, 4097, 64, dtype, seed=31)
    if train:
        mean, var, _ = masked_stats(x, mask)
    else:
        mean, var = rm, rv
    for relu, row_mask in EPILOGUES:
        args = (x, mask, mean, var, w, b, 1e-3, relu, row_mask, dtype)
        direct = masked_stats_module._masked_bn_apply_cuda(*args)
        before = masked_batch_norm.launches
        got = masked_stats_module.masked_bn_apply(*args)
        assert masked_batch_norm.launches == before + 1
        assert got.dtype == dtype and torch.equal(got, direct)
        torch.library.opcheck(masked_stats_module.masked_bn_apply, args)


def test_exported_serving_on_the_card_launches_the_kernels(cuda_device, tmp_path):
    """The tiny SECOND (bf16) exported on the card, saved and loaded: bit-equal
    to the eager serve on the same frames, with the same K1 and apply
    launches a request (12 / 12), and none while exporting."""
    import numpy as np

    from robustpointclouds_tpu_torch.cli import export
    from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg
    from robustpointclouds_tpu_torch.data.synthetic import synthetic_kitti_batch
    from robustpointclouds_tpu_torch.models.voxelnet import AdversarialVoxelNet, init_weights

    cfg = tiny_voxelnet_cfg()
    model = AdversarialVoxelNet(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    anchors, _ = cfg.make_anchors()
    head = cfg.head._replace(score_thr=0.0)

    def launches():
        return sparse_conv.launches, masked_batch_norm.launches

    before = launches()
    ep, meta = export.export_program(model, anchors, head, 2, 4000, device=cuda_device)
    assert launches() == before and meta["platforms"] == ["cuda"]
    path = str(tmp_path / "second.pt2")
    export.save_exported(ep, meta, path)
    call, _ = export.load_exported(path)
    serve = export.export_serving(model, None, anchors, head)
    for seed in (0, 1):
        b = synthetic_kitti_batch(np.random.RandomState(seed), batch_size=2, num_points=4000,
                                  max_gt=8, num_objects=3,
                                  point_range=cfg.voxelizer.point_cloud_range)
        pts = torch.from_numpy(np.asarray(b.points)).to(cuda_device)
        msk = torch.from_numpy(np.asarray(b.points_mask)).to(cuda_device)
        before = launches()
        want = serve(pts, msk)
        eager = tuple(a - b for a, b in zip(launches(), before))
        before = launches()
        got = call(pts, msk)
        loaded = tuple(a - b for a, b in zip(launches(), before))
        assert eager == loaded == (12, 12)
        assert int(want[3].sum()) > 0
        for g, w in zip(got, want):
            assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
