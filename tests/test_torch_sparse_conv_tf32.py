"""The float32 sparse-conv kernels (3xTF32 on the tensor cores), checked on the CPU.

Their launch plans (`tf32_gemm_plan`, `wgrad_plan(..., elem_bytes=4)` in
kernels/sparse_conv.py) are plain Python: every launch of the full-width
SECOND encoder -- forward, dgrad and wgrad of each of its 12 convs -- is
held here to the card's limits before it reaches the card, and the plans'
constants to the CUDA source's. Their arithmetic is too: `split_tf32`
emulates the kernels' operand split (cvt.rna.tf32.f32) on float32 bits, and
`sparse_conv_3xtf32_ref` their three products, which must agree in float32
with the JAX sparse convs that the Pallas merge-path kernel stands in for.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.ops import mp_conv, sparse
from robustpointclouds_tpu.ops import subm_conv as sc_jax

from robustpointclouds_tpu_torch.kernels import sparse_conv as sc
from robustpointclouds_tpu_torch.ops import sparse as tsparse

from test_torch_sparse_conv import DOWN, OUT, SUBM, _grid
from test_torch_sparse_conv_plan import CONVS, ROW_COUNTS, SECOND_CONVS
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

TF32_SOURCE = os.path.join(os.path.dirname(sc.__file__), os.pardir, "csrc",
                           "sparse_conv_tf32.cu")
# the widths of the SECOND encoder's convs: (Cin, Cout, K); CenterPoint's
# wider ones are held in tests/test_torch_centerpoint_ops.py
WIDTHS = sorted({(cin, cout, k) for _, cin, cout, k in SECOND_CONVS})


def _check_gemm_plan(plan, cin, cout, k):
    assert plan.smem_bytes <= sc.SMEM_LIMIT
    assert plan.tile_m % 16 == 0 and 16 <= plan.tile_m <= sc._TF32_MAX_TILE_M
    # a warp per 16 rows and 64 columns
    assert plan.threads == plan.tile_m // 16 * max(1, plan.cout_pad // 64) * 32
    assert plan.threads <= sc._TF32_MAX_THREADS
    assert plan.cin_pad >= cin and plan.cin_pad in (8, 16, 32, 64, 128)  # k8 steps
    assert plan.cout_pad >= cout and plan.cout_pad in (8, 16, 32, 64, 128)  # n8 tiles
    # 16-byte cp.async pieces; the A fragment's 8 rows x 4 columns and the
    # W fragment's 4 rows x 8 columns each fall on 32 distinct banks
    assert plan.a_pitch % 16 == 0 and plan.w_pitch % 16 == 0
    a_words, w_words = plan.a_pitch // 4, plan.w_pitch // 4
    assert len({(r * a_words + c) % 32 for r in range(8) for c in range(4)}) == 32
    assert len({(r * w_words + c) % 32 for r in range(4) for c in range(8)}) == 32
    stage = plan.tile_m * plan.a_pitch + plan.cin_pad * plan.w_pitch
    idx_bytes = -(-plan.tile_m * k * 4 // 16) * 16
    assert plan.smem_bytes == idx_bytes + plan.stages * stage
    assert plan.stages in (2, 3)
    # three stages exactly where two blocks still fit an SM
    assert (plan.stages == 3) == (idx_bytes + 3 * stage <= sc._TF32_TWO_BLOCKS_SMEM)


@pytest.mark.parametrize("name,cin,cout,k", CONVS, ids=[c[0] for c in CONVS])
def test_float32_forward_plan_fits_the_card(name, cin, cout, k):
    _check_gemm_plan(sc.tf32_gemm_plan(cin, cout, k), cin, cout, k)


@pytest.mark.parametrize("name,cin,cout,k", CONVS, ids=[c[0] for c in CONVS])
def test_float32_dgrad_plan_fits_the_card(name, cin, cout, k):
    # the dgrad gathers g's Cout columns and writes Cin (4 for conv_input)
    _check_gemm_plan(sc.tf32_gemm_plan(cout, cin, k), cout, cin, k)


@pytest.mark.parametrize("name,cin,cout,k", CONVS, ids=[c[0] for c in CONVS])
def test_float32_wgrad_plan_fits_the_card(name, cin, cout, k):
    for m in ROW_COUNTS:
        plan = sc.wgrad_plan(m, k, cin, cout, elem_bytes=4)
        assert plan.smem_bytes <= sc.SMEM_LIMIT
        # 16x16 tiles of [Cin, Cout]
        assert plan.cin_pad >= cin and plan.cin_pad in (16, 32, 64, 128)
        assert plan.cout_pad >= cout and plan.cout_pad in (16, 32, 64, 128)
        # both operands' fragments read 4 hit rows x 8 consecutive columns
        for pitch in (plan.a_pitch, plan.g_pitch):
            assert pitch % 16 == 0
            assert len({(r * (pitch // 4) + c) % 32 for r in range(4) for c in range(8)}) == 32
        assert plan.cap & (plan.cap - 1) == 0 and 16 <= plan.cap <= 1024
        assert 0 < plan.step <= min(256, plan.cap // 2)
        assert plan.cap * (plan.a_pitch + plan.g_pitch) <= sc._TC_WGRAD_SMEM_BYTES
        # float32 rows are twice bf16's: the list holds half as many hits
        bf16 = sc.wgrad_plan(m, k, cin, cout)
        assert plan.cap in (bf16.cap // 2, bf16.cap) and plan.cap >= 16
        # the bf16 wgrad's grid
        assert (plan.rows_per_chunk, plan.chunks) == (bf16.rows_per_chunk, bf16.chunks)
        assert plan.chunks * plan.rows_per_chunk >= m > (plan.chunks - 1) * plan.rows_per_chunk


@pytest.mark.parametrize("cin,cout,k", [(6, 16, 27), (16, 6, 27), (256, 16, 27), (16, 256, 3),
                                        (16, 16, 33), (0, 16, 27), (16, 16, 0)])
def test_float32_plans_refuse_what_the_kernels_cannot_take(cin, cout, k):
    with pytest.raises(ValueError):
        sc.tf32_gemm_plan(cin, cout, k)
    if 0 < k <= 32:  # the wgrad's grid takes any number of taps
        with pytest.raises(ValueError):
            sc.wgrad_plan(1000, k, cin, cout, elem_bytes=4)


@pytest.mark.parametrize("tile_m,cout", [(8, 16), (144, 16), (128, 128), (96, 128), (40, 16)])
def test_float32_forward_plan_refuses_other_tiles(monkeypatch, tile_m, cout):
    # a tile is whole warps of 16 rows, at most 128 rows and 256 threads
    # (two warps per 16 rows at Cout = 128)
    monkeypatch.setattr(sc, "_TF32_TILE_M", tile_m)
    with pytest.raises(ValueError):
        sc.tf32_gemm_plan(16, cout, 27)


@pytest.mark.parametrize("tile_m,cout", [(16, 16), (48, 128), (128, 64), (112, 8)])
def test_float32_forward_plan_takes_other_tiles(monkeypatch, tile_m, cout):
    monkeypatch.setattr(sc, "_TF32_TILE_M", tile_m)
    _check_gemm_plan(sc.tf32_gemm_plan(16, cout, 27), 16, cout, 27)


def test_float32_plan_constants_match_the_cuda_source():
    with open(TF32_SOURCE) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxStages"]) == sc._TF32_MAX_STAGES
    assert int(consts["kMaxTaps"]) == sc._TC_MAX_TAPS
    assert int(consts["kMaxTileM"]) == sc._TF32_MAX_TILE_M
    assert int(consts["kMaxThreads"]) == sc._TF32_MAX_THREADS
    assert int(consts["kWarpN"]) == sc._TF32_WARP_N
    assert int(consts["kWgradThreads"]) == sc._TC_WGRAD_THREADS
    assert int(consts["kMaxCap"]) == sc._TC_WGRAD_MAX_CAP
    assert sc._TF32_TILE_M <= int(consts["kMaxTileM"])
    # the pitch rules: width + 4, and width + 8 (+ 16 at width 8)
    assert "return width + 4;" in src
    assert [sc.tf32_col_pitch(w) for w in (8, 16, 32, 64, 128)] == [24, 24, 40, 72, 136]


def _f32(rng, shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("kind", ["randn", "wide", "ties"])
def test_split_tf32_rebuilds_x(kind):
    rng = np.random.RandomState(0)
    x = _f32(rng, (4096,))
    if kind == "wide":
        x *= np.float32(2.0) ** rng.randint(-100, 100, x.shape).astype(np.float32)
    elif kind == "ties":  # exactly half of the 13 dropped bits: away from zero
        x = ((x.view(np.int32) & ~0x1FFF) | 0x1000).view(np.float32)
    t = torch.from_numpy(x)
    big, small = sc.split_tf32(t)
    for part in (big, small):  # tf32 values: 10 fraction bits
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # x - big is exact, small rounds it to 11 significant bits: 2^-22 of x
    err = (t.double() - big.double() - small.double()).abs()
    assert (err <= 2.0 ** -21 * t.double().abs()).all()
    assert ((t - big).double() == t.double() - big.double()).all()
    # big is x rounded to nearest: within half a tf32 ulp, ties away from zero
    assert ((t.double() - big.double()).abs() <= 2.0 ** -11 * t.double().abs()).all()
    if kind == "ties":
        assert (big.abs() > t.abs()).all()


def test_split_tf32_non_finite():
    t = torch.tensor([float("inf"), -float("inf"), float("nan"), 3.4028235e38, 0.0, -0.0,
                      1e-45])
    big, small = sc.split_tf32(t)
    # +-Inf keep themselves and give a NaN small part: a product with them is
    # NaN, not finite; the largest float32 rounds up to Inf
    assert torch.equal(big[:2], t[:2]) and torch.isnan(small[:2]).all()
    assert torch.isnan(big[2]) and torch.isinf(big[3])
    assert torch.equal(big[4:6].view(torch.int32), t[4:6].view(torch.int32))
    # float32's smallest subnormal (2^-149) is below tf32's (2^-136): both parts 0
    assert small[4:].abs().max().item() == 0.0 and big[6].item() == 0.0


def _feats_kernel(rng, g, cin, cout, k):
    feats = _f32(rng, (g.mask.shape[0], cin))
    feats = np.where(np.asarray(g.mask)[:, None], feats, 0).astype(np.float32)
    return feats, _f32(rng, (k * cin, cout), 0.2)


def _scale_err(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("cin,cout,k", WIDTHS)
def test_three_products_match_jax_in_float32(cin, cout, k):
    # a small grid at the encoder's widths: a submanifold conv (K = 27) or
    # conv_out's strided 3-tap conv, the JAX float32 ops on the same inputs
    rng = np.random.RandomState(cin * cout + k)
    g = _grid(rng, (2, 6, 10, 12), 160, 192)
    feats, kernel = _feats_kernel(rng, g, cin, cout, k)
    f, w = jnp.asarray(feats), jnp.asarray(kernel)
    if k == 27:
        idx = torch.from_numpy(np.array(sparse.neighbor_index(g, g.coords, g.mask, *SUBM)))
        ref = sc_jax.subm_conv(f, w, jnp.asarray(idx.numpy()))
    else:
        og, jidx, inv = sparse.downsample_with_index(g, *OUT, out_cap=192, forward=True)
        idx = tsparse.inverse_from_forward(torch.from_numpy(np.array(inv)),
                                           og.flat_ids.shape[0])
        ref = sc_jax.strided_conv_t(f, w, jidx, inv)
    got = sc.sparse_conv_3xtf32_ref(torch.from_numpy(feats), torch.from_numpy(kernel), idx)
    assert got.dtype == torch.float32
    # what the split leaves out is ~2^-21 of each product, and float32 sums
    # run in another order: 1e-6 of the output's scale
    assert _scale_err(got.numpy(), ref) <= 1e-6
    # the plain float32 version agrees as closely
    assert _scale_err(sc.sparse_conv_ref(torch.from_numpy(feats), torch.from_numpy(kernel),
                                         idx).numpy(), ref) <= 1e-6


@pytest.mark.parametrize("geom", [DOWN, OUT])
def test_three_products_match_jax_strided_dgrad(geom):
    # the dgrad's operands: g through the inverse index with per-tap
    # transposed weights, against the VJP of the JAX strided conv
    import jax

    rng = np.random.RandomState(7)
    g = _grid(rng, (2, 6, 10, 12), 160, 192)
    k, s, p = geom
    ktaps = int(np.prod(k))
    og, jidx, inv = sparse.downsample_with_index(g, k, s, p, out_cap=192, forward=True)
    feats, kernel = _feats_kernel(rng, g, 16, 32, ktaps)
    gout = _f32(rng, (192, 32))
    _, vjp = jax.vjp(lambda x: sc_jax.strided_conv_t(x, jnp.asarray(kernel), jidx, inv),
                     jnp.asarray(feats))
    (ref,) = vjp(jnp.asarray(gout))
    w_bwd = sc.backward_kernel(torch.from_numpy(kernel), ktaps, mirror=False)
    got = sc.sparse_conv_3xtf32_ref(torch.from_numpy(gout), w_bwd,
                                    torch.from_numpy(np.array(inv)))
    assert _scale_err(got.numpy(), ref) <= 1e-6


def test_three_products_match_the_pallas_kernel_on_bf16_inputs():
    # on bf16-exact inputs the small parts are 0 and the three products are
    # the exact float32 sum; the Pallas merge-path kernel (interpret mode,
    # bf16 payloads, as tests/test_mp_gather_kernel.py runs it) rounds its
    # rows and outputs to bf16, so the tolerance is that test's
    rng = np.random.RandomState(0)
    g = _grid(rng, (1, 5, 6, 7), 40, 64)
    cin = cout = 8
    feats = jnp.asarray(_f32(rng, (64, cin))).astype(jnp.bfloat16)
    feats = jnp.where(g.mask[:, None], feats, 0)
    w = (jnp.asarray(_f32(rng, (27 * cin, cout))) * 0.2).astype(jnp.bfloat16)
    idx = sparse.neighbor_index(g, g.coords, g.mask, *SUBM)
    pack = mp_conv.subm_mp3_pack(g, SUBM[0], D=16, wlen=48)
    ref = np.asarray(mp_conv.mp3_subm_conv(3, 16, 48, feats, w, pack, interpret=True), np.float32)
    ft = torch.from_numpy(np.asarray(feats, np.float32))
    wt = torch.from_numpy(np.asarray(w, np.float32))
    assert not sc.split_tf32(ft)[1].any() and not sc.split_tf32(wt)[1].any()
    got = sc.sparse_conv_3xtf32_ref(ft, wt, torch.from_numpy(np.array(idx)))
    m = np.asarray(g.mask)
    np.testing.assert_allclose(got.numpy()[m], ref[m], rtol=5e-2, atol=5e-2)
    # and the float32 sum itself, exactly
    assert torch.equal(got, sc.sparse_conv_ref(ft, wt, torch.from_numpy(np.array(idx))))
