"""The port's hand-written kernels against their plain PyTorch versions, on the card.

Marked `cuda` and skipped where there is no NVIDIA card. This file imports
torch only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

import robustpointclouds_tpu_torch.kernels.sparse_conv as sparse_conv_module
from robustpointclouds_tpu_torch.kernels.masked_stats import (
    masked_stats, masked_stats_bwd, masked_stats_bwd_ref, masked_stats_ref)
from robustpointclouds_tpu_torch.kernels.sparse_conv import (
    backward_kernel, sparse_conv, sparse_conv_dgrad, sparse_conv_ref, sparse_conv_train,
    sparse_conv_wgrad, sparse_conv_wgrad_ref)

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


@pytest.mark.parametrize("n,c,dtype", [(480000, 4, torch.float32), (96000, 64, torch.bfloat16),
                                       (1000, 3, torch.float32)])
def test_masked_stats_matches_plain_version(cuda_device, n, c, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(n, c, device=cuda_device, generator=g) * 3 + 1).to(dtype)
    mask = torch.rand(n, device=cuda_device, generator=g) > 0.75
    mean, var, cnt = masked_stats(x, mask)
    rm, rv, rc = masked_stats_ref(x, mask)
    # float32 statistics, one pass merged by Chan's formula vs two passes
    torch.testing.assert_close(mean, rm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(var, rv, rtol=1e-4, atol=1e-4)
    assert cnt.item() == rc.item()


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
                                       (96000, 64, torch.float32), (1000, 3, torch.float32)])
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
    counters = (sparse_conv, sparse_conv_dgrad, sparse_conv_wgrad, masked_stats, masked_stats_bwd)
    before = [fn.launches for fn in counters]
    steps = 2
    make_plan_attack(tr, steps=steps)(b, plan)
    torch.cuda.synchronize()
    launched = [fn.launches - n for fn, n in zip(counters, before)]
    # per step: the 12 convs' forward and input gradient; eval-mode BN, no adversary
    assert launched == [12 * steps, 12 * steps, 0, 0, 0]
    assert all(p.requires_grad for p in tr.model.parameters())
