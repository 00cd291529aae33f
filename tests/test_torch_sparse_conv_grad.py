"""The port's sparse-conv backward (SparseConvFunction) against jax.grad through the JAX custom VJPs.

On the CPU the autograd Function runs the plain versions along the same
formulas the card's kernels use: d_feats is the gather-GEMM of the output
cotangent with per-tap transposed weights over the backward index (the
forward index with mirrored taps for a submanifold conv, the inverse index
for a strided one), and d_W is gather-then-col^T·g in float32. They must
match the JAX VJPs of subm_conv, subm_conv_xwin, strided_conv_t and
strided_conv_xwin in float32 (summation order only), and the Pallas
merge-path kernel's VJPs (mp3_*, interpret mode) in bf16 at that kernel's
own test tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.ops import mp_conv, sparse
from robustpointclouds_tpu.ops import subm_conv as sc

from robustpointclouds_tpu_torch.kernels.sparse_conv import (
    backward_kernel, sparse_conv_dgrad, sparse_conv_train, sparse_conv_wgrad,
    sparse_conv_wgrad_ref)
from robustpointclouds_tpu_torch.ops import sparse as tsparse
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

SUBM = ((1, 3, 3, 3), (1, 1, 1, 1), (0, 1, 1, 1))
DOWN = ((1, 3, 3, 3), (1, 2, 2, 2), (0, 1, 1, 1))
OUT = ((1, 3, 1, 1), (1, 2, 1, 1), (0, 0, 0, 0))
# float32 gathers + matmuls on both sides; only the summation order differs
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# the grids of tests/test_subm_conv.py and tests/test_xwin_conv.py
GRIDS = [((1, 5, 6, 7), 40, 64), ((2, 6, 10, 12), 160, 192)]


def _grid(rng, shape, n_active, n_pad):
    total = int(np.prod(shape))
    flat = np.sort(rng.choice(total, min(n_active, total), replace=False))
    coords = np.full((n_pad, 4), -1, np.int32)
    coords[:len(flat)] = np.stack(np.unravel_index(flat, shape), axis=1)
    mask = np.arange(n_pad) < len(flat)
    return sparse.make_grid(jnp.asarray(coords), jnp.asarray(mask), shape)


# the JAX index builders, jitted once per geometry (eager they compile every
# primitive separately, ~8x slower here)
def _subm_index(g):
    def fn(ids, coords, mask):
        gg = sparse.SparseGrid(ids, coords, mask, g.spatial_shape)
        xw = sparse.neighbor_xwin_info(gg, coords, mask, *SUBM)
        return sparse.neighbor_index(gg, coords, mask, *SUBM), xw.rows, xw.xvalid
    return jax.jit(fn)(g.flat_ids, g.coords, g.mask)


def _downsample(g, geom, out_cap):
    k, s, p = geom

    def fn(ids, coords, mask):
        gg = sparse.SparseGrid(ids, coords, mask, g.spatial_shape)
        og, idx, inv = sparse.downsample_with_index(gg, k, s, p, out_cap=out_cap, forward=True)
        return og.flat_ids, og.coords, og.mask, idx, inv
    ids, coords, mask, idx, inv = jax.jit(fn)(g.flat_ids, g.coords, g.mask)
    shape = tuple((d + 2 * pp - kk) // ss + 1 for d, kk, ss, pp in zip(g.spatial_shape, k, s, p))
    return sparse.SparseGrid(ids, coords, mask, shape), idx, inv


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _torch_grads(feats, kernel, idx, bwd_idx, mirror, g_out):
    f = _t(feats).requires_grad_(True)
    w = _t(kernel).requires_grad_(True)
    out = sparse_conv_train(f, w, idx, bwd_idx, mirror)
    (out.float() * _t(g_out).float()).sum().backward()
    return out.detach(), f.grad, w.grad


def _jax_grads(fn, feats, kernel, g_out):
    def loss(f, w):
        return jnp.sum(fn(f, w).astype(jnp.float32) * jnp.asarray(g_out, jnp.float32))
    return jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(feats), jnp.asarray(kernel))


def _data(rng, n_in, n_out, cin, cout, k, in_mask, out_mask):
    feats = rng.randn(n_in, cin).astype(np.float32) * np.asarray(in_mask)[:, None]
    kernel = (rng.randn(k * cin, cout) * 0.2).astype(np.float32)
    g_out = rng.randn(n_out, cout).astype(np.float32) * np.asarray(out_mask)[:, None]
    return feats, kernel, g_out


@pytest.mark.parametrize("shape,n_active,n_pad", GRIDS)
@pytest.mark.parametrize("cin,cout", [(4, 16), (32, 64)])
def test_subm_grads_match_subm_conv_and_xwin(shape, n_active, n_pad, cin, cout):
    rng = np.random.RandomState(0)
    g = _grid(rng, shape, n_active, n_pad)
    idx, rows, xvalid = _subm_index(g)
    feats, kernel, g_out = _data(rng, n_pad, n_pad, cin, cout, 27, g.mask, g.mask)
    tidx = _t(idx)
    _, gf, gw = _torch_grads(feats, kernel, tidx, tidx, True, g_out)
    jf, jw = _jax_grads(lambda f, w: sc.subm_conv(f, w, idx), feats, kernel, g_out)
    np.testing.assert_allclose(gf.numpy(), np.asarray(jf), **F32_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), **F32_TOL)
    # the plan's x-window layout, converted to the dense index the port takes
    xidx = tsparse.xwin_to_index(_t(rows), _t(xvalid), _t(g.flat_ids), 3)
    _, gf2, gw2 = _torch_grads(feats, kernel, xidx, xidx, True, g_out)
    jf2, jw2 = _jax_grads(lambda f, w: sc.subm_conv_xwin(3, f, w, g.flat_ids, rows, xvalid),
                          feats, kernel, g_out)
    np.testing.assert_allclose(gf2.numpy(), np.asarray(jf2), **F32_TOL)
    np.testing.assert_allclose(gw2.numpy(), np.asarray(jw2), **F32_TOL)


@pytest.mark.parametrize("geom", [DOWN, OUT])
@pytest.mark.parametrize("shape,n_active,n_pad", GRIDS)
def test_strided_grads_match_strided_conv_t_and_xwin(shape, n_active, n_pad, geom):
    rng = np.random.RandomState(1)
    g = _grid(rng, shape, n_active, n_pad)
    k, s, p = geom
    ktaps = int(np.prod(k))
    og, idx, inv = _downsample(g, geom, n_pad)
    feats, kernel, g_out = _data(rng, n_pad, og.flat_ids.shape[0], 16, 32, ktaps, g.mask, og.mask)
    fwd = tsparse.inverse_from_forward(_t(inv), og.flat_ids.shape[0])
    out, gf, gw = _torch_grads(feats, kernel, fwd, _t(inv), False, g_out)
    jf, jw = _jax_grads(lambda f, w: sc.strided_conv_t(f, w, idx, inv), feats, kernel, g_out)
    np.testing.assert_allclose(gf.numpy(), np.asarray(jf), **F32_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), **F32_TOL)
    # and against plain autodiff (the scatter-add backward of strided_conv)
    ja, jb = _jax_grads(lambda f, w: sc.strided_conv(f, w, idx), feats, kernel, g_out)
    np.testing.assert_allclose(gf.numpy(), np.asarray(ja), **F32_TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jb), **F32_TOL)
    if geom == DOWN:  # the plan's x-window forward form of down1/down2
        xw = jax.jit(lambda i, c, m: sparse.xwin_from_index(
            i, c, m, k[-1], g.flat_ids.shape[0], s[-1], p[-1], g.spatial_shape[-1])[:2])(
                idx, og.coords, og.mask)
        xw = sparse.XWindowInfo(xw[0], xw[1], k[-1], g.flat_ids.shape[0])
        jf2, jw2 = _jax_grads(lambda f, w: sc.strided_conv_xwin(
            f, w, g.flat_ids, xw.rows, xw.xvalid, inv), feats, kernel, g_out)
        np.testing.assert_allclose(gf.numpy(), np.asarray(jf2), **F32_TOL)
        np.testing.assert_allclose(gw.numpy(), np.asarray(jw2), **F32_TOL)


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.randn(*shape).astype(np.float32) * scale).astype(jnp.bfloat16)


def _f32(x):
    return np.asarray(x, np.float32)


def test_subm_grads_match_pallas_merge_path_kernel():
    # the tests/test_mp_gather_kernel.py:81 geometry (D=16, WLEN=48), bf16,
    # at that test's forward tolerance: bf16 rounding of rows and outputs
    rng = np.random.RandomState(2)
    g = _grid(rng, (2, 4, 5, 5), 50, 72)
    cin, cout = 8, 4
    feats = jnp.where(g.mask[:, None], _bf16(rng, (72, cin)), 0)
    w = _bf16(rng, (27 * cin, cout), 0.2)
    g_out = jnp.where(g.mask[:, None], _bf16(rng, (72, cout)), 0)
    pack = mp_conv.subm_mp3_pack(g, SUBM[0], D=16, wlen=48)
    jf, jw = jax.jit(jax.grad(lambda f, ww: jnp.sum(
        mp_conv.mp3_subm_conv(3, 16, 48, f, ww, pack, interpret=True).astype(jnp.float32)
        * g_out.astype(jnp.float32)), argnums=(0, 1)))(feats, w)
    idx = _t(_subm_index(g)[0])
    _, gf, gw = _torch_grads(_f32(feats), _f32(w), idx, idx, True, _f32(g_out))
    m = np.asarray(g.mask)
    np.testing.assert_allclose(gf.numpy()[m], _f32(jf)[m], rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(gw.numpy(), _f32(jw), rtol=5e-2, atol=5e-2)
    # and the port in bf16 itself: d_feats in bf16, d_W float32
    fb = _t(_f32(feats), torch.bfloat16).requires_grad_(True)
    wb = _t(_f32(w)).requires_grad_(True)
    out = sparse_conv_train(fb, wb, idx, idx, True)
    (out.float() * _t(_f32(g_out))).sum().backward()
    assert fb.grad.dtype == torch.bfloat16 and wb.grad.dtype == torch.float32
    np.testing.assert_allclose(fb.grad.float().numpy()[m], _f32(jf)[m], rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(wb.grad.numpy(), _f32(jw), rtol=5e-2, atol=5e-2)


def test_strided_grads_match_pallas_merge_path_kernel():
    # the tests/test_mp_gather_kernel.py:111 geometry
    rng = np.random.RandomState(7)
    geom, kx, n_pad = DOWN, 3, 64
    in_g = _grid(rng, (1, 6, 8, 8), 40, n_pad)
    k4, s4, p4 = geom
    ktaps = int(np.prod(k4))
    out_g, idx, inv = _downsample(in_g, geom, n_pad)
    cin = cout = 8
    feats = jnp.where(in_g.mask[:, None], _bf16(rng, (n_pad, cin)), 0)
    w = _bf16(rng, (ktaps * cin, cout), 0.2)
    g_out = jnp.where(out_g.mask[:, None], _bf16(rng, (n_pad, cout)), 0)
    pack = mp_conv.strided_mp3_pack(in_g, out_g, k4, s4, p4, D=16, wlen=48)
    jf, jw = jax.jit(jax.grad(lambda f, ww: jnp.sum(
        mp_conv.mp3_strided_conv(kx, 16, 48, f, ww, pack, inv, interpret=True)
        .astype(jnp.float32) * g_out.astype(jnp.float32)), argnums=(0, 1)))(feats, w)
    fwd = tsparse.inverse_from_forward(_t(inv), n_pad)
    _, gf, gw = _torch_grads(_f32(feats), _f32(w), fwd, _t(inv), False, _f32(g_out))
    m = np.asarray(in_g.mask)
    np.testing.assert_allclose(gf.numpy()[m], _f32(jf)[m], rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(gw.numpy(), _f32(jw), rtol=5e-2, atol=5e-2)


def test_backward_kernel_layout_and_cpu_wrappers():
    rng = np.random.RandomState(3)
    k, cin, cout = 27, 4, 16
    w = torch.from_numpy(rng.randn(k * cin, cout).astype(np.float32))
    wb = backward_kernel(w, k, mirror=True)
    assert wb.shape == (k * cout, cin) and wb.is_contiguous()
    # tap t of the mirrored transposed weight is W_{K-1-t}^T
    torch.testing.assert_close(wb[:cout], w[(k - 1) * cin:].t())
    torch.testing.assert_close(backward_kernel(w, k, mirror=False)[:cout], w[:cin].t())
    feats = torch.from_numpy(rng.randn(10, cin).astype(np.float32))
    g = torch.from_numpy(rng.randn(7, cout).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 11, (7, k)).astype(np.int32))
    before = (sparse_conv_dgrad.launches, sparse_conv_wgrad.launches)
    torch.testing.assert_close(sparse_conv_wgrad(feats, g, idx), sparse_conv_wgrad_ref(feats, g, idx))
    sparse_conv_dgrad(g, backward_kernel(w, k, False), idx[:, :].clamp(max=7)[:10])
    assert (sparse_conv_dgrad.launches, sparse_conv_wgrad.launches) == before  # CPU: no launch
    with pytest.raises(ValueError):
        sparse_conv_wgrad(feats.to("meta"), g.to("meta"), idx.to("meta"))
