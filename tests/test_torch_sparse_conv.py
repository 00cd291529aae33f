"""The port's sparse-conv index converters and the gather-GEMM's plain version vs the JAX ops.

The converters turn the plan's x-window and inverse layouts into the dense
[M, K] index that the port's one sparse-conv kernel takes; they must equal
the JAX index builders exactly. `sparse_conv_ref` (the plain version the
CPU path runs and the card's kernel is held against) must equal the JAX conv
ops in float32 to summation-order rounding, and the Pallas merge-path kernel
(interpret mode) in bf16 within that kernel's own test tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.ops import mp_conv, sparse
from robustpointclouds_tpu.ops import subm_conv as sc

from robustpointclouds_tpu_torch.kernels.sparse_conv import sparse_conv, sparse_conv_ref
from robustpointclouds_tpu_torch.ops import sparse as tsparse
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

SUBM = ((1, 3, 3, 3), (1, 1, 1, 1), (0, 1, 1, 1))
DOWN = ((1, 3, 3, 3), (1, 2, 2, 2), (0, 1, 1, 1))
DOWN_Z0 = ((1, 3, 3, 3), (1, 2, 2, 2), (0, 0, 1, 1))
OUT = ((1, 3, 1, 1), (1, 2, 1, 1), (0, 0, 0, 0))
# float32 gather + matmul on both sides; only the summation order differs
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _grid(rng, shape, n_active, n_pad):
    """Random active sites; the grids of test_subm_conv (shape (1,5,6,7), 40 of
    64) and test_xwin_conv (shape (2,6,10,12), 160 of 192)."""
    total = int(np.prod(shape))
    flat = np.sort(rng.choice(total, n_active, replace=False))
    coords = np.full((n_pad, 4), -1, np.int32)
    coords[:n_active] = np.stack(np.unravel_index(flat, shape), axis=1)
    mask = np.arange(n_pad) < n_active
    return sparse.make_grid(jnp.asarray(coords), jnp.asarray(mask), shape)


GRIDS = [((1, 5, 6, 7), 40, 64), ((2, 6, 10, 12), 160, 192)]


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("kernel", [(1, 3, 3, 3), (1, 3, 1, 1)])
def test_kernel_offsets_match(kernel):
    # the tap order every index and every img2col weight follows
    np.testing.assert_array_equal(tsparse.kernel_offsets(kernel), sparse.kernel_offsets(kernel))


@pytest.mark.parametrize("shape,n_active,n_pad", GRIDS)
def test_xwin_to_index_matches_neighbor_index(shape, n_active, n_pad):
    g = _grid(np.random.RandomState(0), shape, n_active, n_pad)
    k, s, p = SUBM
    xw = sparse.neighbor_xwin_info(g, g.coords, g.mask, k, s, p)
    ref = sparse.neighbor_index(g, g.coords, g.mask, k, s, p)
    got = tsparse.xwin_to_index(_t(xw.rows), _t(xw.xvalid), _t(g.flat_ids), xw.kx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("geom", [DOWN, DOWN_Z0, OUT])
@pytest.mark.parametrize("shape,n_active,n_pad", GRIDS)
def test_forward_index_from_inverse(shape, n_active, n_pad, geom):
    # the strided convs' forward index is the transpose of the plan's inverse
    g = _grid(np.random.RandomState(1), shape, n_active, n_pad)
    k, s, p = geom
    og, idx, inv = sparse.downsample_with_index(g, k, s, p, out_cap=n_pad, forward=True)
    got = tsparse.inverse_from_forward(_t(inv), og.flat_ids.shape[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(idx))
    # and back: the transpose is its own inverse on real entries
    back = tsparse.inverse_from_forward(got, g.flat_ids.shape[0])
    np.testing.assert_array_equal(back.numpy(), np.asarray(inv))


@pytest.mark.parametrize("shape,n_active,n_pad", GRIDS)
def test_strided_xwin_to_index_matches_forward(shape, n_active, n_pad):
    # the plan's down1/down2 x-window form converts to the same forward index
    g = _grid(np.random.RandomState(2), shape, n_active, n_pad)
    k, s, p = DOWN
    og, idx, _ = sparse.downsample_with_index(g, k, s, p, out_cap=n_pad, forward=True)
    xw = sparse.xwin_from_index(idx, og.coords, og.mask, k[-1], g.flat_ids.shape[0],
                                s[-1], p[-1], g.spatial_shape[-1])
    got = tsparse.xwin_to_index(_t(xw.rows), _t(xw.xvalid), _t(g.flat_ids), xw.kx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(idx))


def _feats_kernel(rng, g, cin, cout, k=27):
    n = g.flat_ids.shape[0]
    feats = rng.randn(n, cin).astype(np.float32) * np.asarray(g.mask)[:, None]
    kernel = (rng.randn(k * cin, cout) * 0.2).astype(np.float32)
    return feats, kernel


@pytest.mark.parametrize("shape,n_active,n_pad", GRIDS)
@pytest.mark.parametrize("cin,cout", [(4, 16), (16, 32), (64, 64)])
def test_ref_matches_subm_conv_and_xwin(shape, n_active, n_pad, cin, cout):
    rng = np.random.RandomState(3)
    g = _grid(rng, shape, n_active, n_pad)
    k, s, p = SUBM
    idx = sparse.neighbor_index(g, g.coords, g.mask, k, s, p)
    xw = sparse.neighbor_xwin_info(g, g.coords, g.mask, k, s, p)
    feats, kernel = _feats_kernel(rng, g, cin, cout)
    f, w = jnp.asarray(feats), jnp.asarray(kernel)
    got = sparse_conv_ref(_t(feats), _t(kernel), _t(idx)).numpy()
    np.testing.assert_allclose(got, np.asarray(sc.subm_conv(f, w, idx)), **F32_TOL)
    got_xw = sparse_conv_ref(_t(feats), _t(kernel), tsparse.xwin_to_index(
        _t(xw.rows), _t(xw.xvalid), _t(g.flat_ids), xw.kx)).numpy()
    ref_xw = sc.subm_conv_xwin(xw.kx, f, w, g.flat_ids, xw.rows, xw.xvalid)
    np.testing.assert_allclose(got_xw, np.asarray(ref_xw), **F32_TOL)


@pytest.mark.parametrize("geom", [DOWN, OUT])
@pytest.mark.parametrize("shape,n_active,n_pad", GRIDS)
def test_ref_matches_strided_convs(shape, n_active, n_pad, geom):
    rng = np.random.RandomState(4)
    g = _grid(rng, shape, n_active, n_pad)
    k, s, p = geom
    ktaps = int(np.prod(k))
    og, idx, inv = sparse.downsample_with_index(g, k, s, p, out_cap=n_pad, forward=True)
    feats, kernel = _feats_kernel(rng, g, 16, 32, ktaps)
    f, w = jnp.asarray(feats), jnp.asarray(kernel)
    fwd = tsparse.inverse_from_forward(_t(inv), og.flat_ids.shape[0])
    got = sparse_conv_ref(_t(feats), _t(kernel), fwd).numpy()
    np.testing.assert_allclose(got, np.asarray(sc.strided_conv_t(f, w, idx, inv)), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(sc.strided_conv(f, w, idx)), **F32_TOL)


@pytest.mark.parametrize("shape", [(1, 5, 6, 7), (2, 4, 5, 5)])
def test_ref_matches_pallas_merge_path_kernel(shape):
    # the tests/test_mp_gather_kernel.py geometry (D=16, WLEN=48), bf16; the
    # tolerance is that test's: bf16 rounding of the selected rows and outputs
    rng = np.random.RandomState(0)
    g = _grid(rng, shape, min(40, int(np.prod(shape))), 64)
    cin = cout = 8
    feats = jnp.asarray(rng.randn(64, cin).astype(np.float32)).astype(jnp.bfloat16)
    feats = jnp.where(g.mask[:, None], feats, 0)
    w = (jnp.asarray(rng.randn(27 * cin, cout).astype(np.float32)) * 0.2).astype(jnp.bfloat16)
    idx = sparse.neighbor_index(g, g.coords, g.mask, *SUBM)
    pack = mp_conv.subm_mp3_pack(g, SUBM[0], D=16, wlen=48)
    ref = np.asarray(mp_conv.mp3_subm_conv(3, 16, 48, feats, w, pack, interpret=True), np.float32)
    got = sparse_conv_ref(_t(np.asarray(feats, np.float32), torch.bfloat16),
                          _t(np.asarray(w, np.float32), torch.bfloat16), _t(idx))
    assert got.dtype == torch.bfloat16
    m = np.asarray(g.mask)
    np.testing.assert_allclose(got.float().numpy()[m], ref[m], rtol=5e-2, atol=5e-2)


def test_wrapper_takes_plain_version_on_cpu_only():
    rng = np.random.RandomState(5)
    feats = torch.from_numpy(rng.randn(10, 4).astype(np.float32))
    kernel = torch.from_numpy(rng.randn(27 * 4, 16).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 11, (7, 27)).astype(np.int32))
    before = sparse_conv.launches
    torch.testing.assert_close(sparse_conv(feats, kernel, idx), sparse_conv_ref(feats, kernel, idx))
    assert sparse_conv.launches == before  # the CPU path launches no kernel
    with pytest.raises(ValueError):
        sparse_conv(feats.to("meta"), kernel.to("meta"), idx.to("meta"))

