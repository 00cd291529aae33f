"""The port's ctypes binding of csrc/plan.cpp must give the JAX binding's plan bit for bit.

Both bind the same unchanged C++ builder (each into its own build
directory), so every leaf — integer index machinery and verbatim point
copies — must be equal, dtype and shape included.
"""
import numpy as np
import pytest

from robustpointclouds_tpu.data import synthetic_kitti_batch
from robustpointclouds_tpu.data.native_plan import build_plan_native as jax_build_plan_native
from robustpointclouds_tpu.ops.voxelize import VoxelizerConfig

from robustpointclouds_tpu_torch.data import native_plan as port_native_plan
from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig as PortVoxelizerConfig
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

# the tests/test_native_plan.py tiny-grid settings
TINY = dict(point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
            voxel_size=(0.5, 0.5, 0.125), max_points_per_voxel=3, max_voxels=512)
TRUNCATING = dict(point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
                  voxel_size=(0.25, 0.25, 0.125), max_points_per_voxel=2, max_voxels=128)


def _compare(ref, got, path=""):
    assert sorted(ref) == sorted(got), path
    for k in ref:
        p = f"{path}/{k}"
        if isinstance(ref[k], dict):
            _compare(ref[k], got[k], p)
            continue
        r, g = np.asarray(ref[k]), np.asarray(got[k])
        assert r.shape == g.shape and r.dtype == g.dtype, (p, r.shape, g.shape, r.dtype, g.dtype)
        np.testing.assert_array_equal(g, r, err_msg=p)


@pytest.mark.parametrize("vz_kw,batch_size,num_points,seed", [
    (TINY, 2, 512, 0),
    (TINY, 3, 700, 1),
    (TRUNCATING, 2, 4000, 5),  # voxel and stage caps truncate
])
def test_port_plan_bit_equal(vz_kw, batch_size, num_points, seed):
    vz = VoxelizerConfig(**vz_kw)
    rng = np.random.RandomState(seed)
    b = synthetic_kitti_batch(rng, batch_size=batch_size, num_points=num_points, max_gt=8,
                              num_objects=3, point_range=vz.point_cloud_range)
    pts, msk = np.asarray(b.points), np.asarray(b.points_mask)
    ref = jax_build_plan_native(pts, msk, vz, 4)
    got = port_native_plan.build_plan_native(pts, msk, PortVoxelizerConfig(**vz_kw), 4)
    _compare(ref, got)


def test_port_builds_its_own_library():
    port_native_plan.get_lib()
    assert port_native_plan._SO.endswith("build/torch_plan/libplan.so")


def test_voxelizer_config_matches():
    a, b = VoxelizerConfig(**TINY), PortVoxelizerConfig(**TINY)
    assert a.grid_size == b.grid_size and a.sparse_shape == b.sparse_shape
