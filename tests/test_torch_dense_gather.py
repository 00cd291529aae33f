"""JAX's gather-form densify (RPC_DENSE_GATHER on SECOND's encoder; the
default of its plan-fed PointPillars) against the port's scatter, on the
CPU at the smoke grid.

The port densifies by a scatter on every path (ops/sparse.scatter_to_dense):
the gather form gives the same numbers and is the slower one on the H100
(chip_smoke.py phase 16 (b)), so the gate is held by this test rather than
ported as code. Held, bit for bit, in float32 and bfloat16: JAX's
`scatter_to_dense_gather` through the cell -> row map that JAX's
HostPlanBuilder attaches under RPC_DENSE_GATHER, forward and VJP, against
the port's scatter and its autograd gradient on the port's host plan of the
same points (whose conv_out grid is JAX's). The pillar BEV grid's
counterpart is tests/test_torch_pointpillars.py::
test_scatter_to_dense_gather_equals_scatter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.cli.common import tiny_voxelnet_cfg as j_tiny_voxelnet_cfg
from robustpointclouds_tpu.nn import sparse_encoder as jse
from robustpointclouds_tpu.ops import sparse as jsparse
from robustpointclouds_tpu.train.loop import HostPlanBuilder as JHostPlanBuilder

from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg
from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch
from robustpointclouds_tpu_torch.ops import sparse as tsparse
from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

from test_model import tiny_batch
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

TRAIN_KW = dict(warmup_iters=5, max_epochs=2, steps_per_epoch=4)


def _out_shape(batch, sparse_shape):
    """conv_out's grid shape, as JAX's HostPlanBuilder derives it."""
    shape = (batch,) + tuple(sparse_shape)
    for i in (1, 2, 3):
        shape = jse._down_shape(shape, *jse._down_geom(4, i))
    return jse._down_shape(shape, *jse._OUT_GEOM)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_form_equals_scatter_form(dtype, monkeypatch):
    cfg = tiny_voxelnet_cfg()
    b = PointCloudBatch(*tiny_batch(np.random.RandomState(6)))
    plan = Trainer(cfg, TrainConfig(**TRAIN_KW), device="cpu").make_plan_builder()(
        b.points, b.points_mask)
    monkeypatch.setattr(jse, "DENSE_GATHER", True)
    jplan = JHostPlanBuilder(j_tiny_voxelnet_cfg())(np.asarray(b.points),
                                                      np.asarray(b.points_mask))
    st, jst = plan["enc"]["out"], jplan["enc"]["out"]
    for k in ("ids", "coords", "mask"):  # the port's conv_out grid is JAX's
        np.testing.assert_array_equal(st[k], np.asarray(jst[k]), err_msg=k)
    shape = _out_shape(b.points.shape[0], cfg.voxelizer.sparse_shape)
    grid = tsparse.SparseGrid(*(torch.from_numpy(st[k]) for k in ("ids", "coords", "mask")), shape)
    jgrid = jsparse.SparseGrid(*(jnp.asarray(st[k]) for k in ("ids", "coords", "mask")), shape)
    dmap = jnp.asarray(jst["dense"])
    np.testing.assert_array_equal(np.asarray(dmap), np.asarray(jsparse.dense_gather_map(jgrid)))

    rng = np.random.RandomState(0)
    n = grid.flat_ids.shape[0]
    feats = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)).to(dtype)
    feats[~grid.mask] = float("nan")  # padding rows must not reach the grid
    g = torch.from_numpy(rng.standard_normal(shape + (8,)).astype(np.float32)).to(dtype)
    x = feats.clone().requires_grad_(True)
    dense = tsparse.scatter_to_dense(x, grid)
    (dx,) = torch.autograd.grad(dense, x, g)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)
    ref, vjp = jax.vjp(lambda f: jsparse.scatter_to_dense_gather(f, jgrid, dmap), to_j(feats))
    as_np = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    assert dense.dtype == dtype and dense.shape == shape + (8,)
    np.testing.assert_array_equal(dense.detach().float().numpy(), as_np(ref))
    np.testing.assert_array_equal(dx.float().numpy(), as_np(vjp(to_j(g))[0]))
    assert dense.abs().sum() > 0 and (dx[~grid.mask] == 0).all()
