"""The JAX package's layout gates of its sparse conv and of its rank search
(ops/subm_conv.py RPC_SAVE_COL, RPC_DW_GCOL, RPC_COL3, RPC_XWIN_SPLIT;
ops/sparse.py RPC_MP_RANKS), held against the port on the CPU.

Each gate changes how XLA gathers, which residual the JAX VJP keeps, or how
JAX's index builder ranks queries, and is exact by design: on the card K1
gathers inside the kernel and the port ranks with `torch.searchsorted`, so
none of them has a counterpart in the port's code. These tests show the
port already computes the numbers each gate defines:
  * with each K1 gate set in JAX (XWIN_SPLIT below and above the widths
    here, 32 by default), the port's K1 route (sparse_conv_train: forward,
    d_feats, d_W) against JAX's subm_conv, subm_conv_xwin, strided_conv_t
    and strided_conv_xwin, float32, at the K1 parity tests' tolerance
    (tests/test_torch_sparse_conv_grad.py: rtol 1e-5, atol 1e-5);
  * with MP_RANKS set in JAX before its jit, the port's inline SECOND plan
    (`encoder_plan` included) bit-equal to JAX's jitted build_plan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.models import voxelnet as jvn
from robustpointclouds_tpu.ops import sparse as jsparse
from robustpointclouds_tpu.ops import subm_conv as sc
from robustpointclouds_tpu.ops import voxelize as jvox

from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.ops import sparse as tsparse

from test_torch_sparse_conv_grad import (DOWN, F32_TOL, _data, _downsample, _grid, _subm_index,
                                         _t, _torch_grads)
from test_torch_inline_plan import _compare, _kitti_points, _to_numpy
from test_torch_native_plan import TINY
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

GRID = ((2, 6, 10, 12), 160, 192)
CIN, COUT = 32, 64  # XWIN_SPLIT 8 halves these gathers; 128 leaves them whole


def _jax_fwd_grads(fn, feats, kernel, g_out):
    def loss(f, w):
        out = fn(f, w)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g_out)), out
    (_, out), (gf, gw) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(feats), jnp.asarray(kernel))
    return out, gf, gw


def _hold(port, ref):
    for got, want in zip(port, ref):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("flag,value", [("SAVE_COL", True), ("DW_FROM_GCOL", True),
                                        ("COL3", True), ("XWIN_SPLIT", 8),
                                        ("XWIN_SPLIT", 128)])
def test_k1_matches_jax_under_each_layout_gate(flag, value, monkeypatch):
    monkeypatch.setattr(sc, flag, value)  # read while JAX traces
    rng = np.random.RandomState(0)
    g = _grid(rng, *GRID)
    idx, rows, xvalid = _subm_index(g)
    feats, kernel, g_out = _data(rng, GRID[2], GRID[2], CIN, COUT, 27, g.mask, g.mask)
    tidx = _t(idx)
    port = _torch_grads(feats, kernel, tidx, tidx, True, g_out)
    _hold(port, _jax_fwd_grads(lambda f, w: sc.subm_conv(f, w, idx), feats, kernel, g_out))
    _hold(port, _jax_fwd_grads(lambda f, w: sc.subm_conv_xwin(3, f, w, g.flat_ids, rows, xvalid),
                               feats, kernel, g_out))

    k, s, p = DOWN
    og, didx, inv = _downsample(g, DOWN, GRID[2])
    feats, kernel, g_out = _data(rng, GRID[2], og.flat_ids.shape[0], CIN, COUT, 27, g.mask,
                                 og.mask)
    fwd = tsparse.inverse_from_forward(_t(inv), og.flat_ids.shape[0])
    port = _torch_grads(feats, kernel, fwd, _t(inv), False, g_out)
    _hold(port, _jax_fwd_grads(lambda f, w: sc.strided_conv_t(f, w, didx, inv), feats, kernel,
                               g_out))
    xw = jax.jit(lambda i, c, m: jsparse.xwin_from_index(
        i, c, m, k[-1], g.flat_ids.shape[0], s[-1], p[-1], g.spatial_shape[-1])[:2])(
            didx, og.coords, og.mask)
    _hold(port, _jax_fwd_grads(lambda f, w: sc.strided_conv_xwin(
        f, w, g.flat_ids, xw[0], xw[1], inv), feats, kernel, g_out))
    assert float(np.abs(np.asarray(port[2])).max()) > 0


def test_inline_plan_matches_jax_under_mp_ranks(monkeypatch):
    monkeypatch.setattr(jsparse, "MP_RANKS", True)  # read while JAX traces
    traced = []
    ranks = jsparse.merge_path_ranks
    monkeypatch.setattr(jsparse, "merge_path_ranks", lambda *a, **k: traced.append(1) or ranks(
        *a, **k))
    cfg = tiny_voxelnet_cfg()._replace(voxelizer=tvn.VoxelizerConfig(**TINY))
    jcfg = jvn.VoxelNetConfig(voxelizer=jvox.VoxelizerConfig(**TINY),
                              anchor_ranges=cfg.anchor_ranges)
    pts, msk, *_ = _kitti_points(TINY, 2, 512, 0)
    got = _to_numpy(tvn.build_plan(torch.from_numpy(pts), torch.from_numpy(msk), cfg))
    ref = _to_numpy(jax.jit(lambda p, m: jvn.build_plan(p, m, jcfg))(pts, msk))
    assert traced  # JAX's build took the merge-path ranks
    _compare(ref, got)
    assert got["enc"]["rel3"]["idx"].min() < got["enc"]["down3"]["ids"].shape[0]
