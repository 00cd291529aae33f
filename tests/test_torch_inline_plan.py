"""The port's inline plan builders against JAX's and the native host plan, bit for bit.

The inline (plan=None) path builds the plan in torch ops on the points'
device (ops/voxelize.py, ops/sparse.py, nn/sparse_encoder.encoder_plan,
models/*.build_*plan). On the CPU every array must equal, dtype and shape
included:
  * each structure builder against the JAX function of the same name on
    seeded random coordinates, in the packed id space, the wide one (past
    2^30, JAX's two-key rank sort) and, for the one-query-per-tap forms,
    past JAX's wide band; and the int32 ceiling's ValueError;
  * `voxelize_batch` and the three families' plans against JAX's jitted
    builders and the port's native ones (data/native_plan.py) on the TINY
    and TRUNCATING voxelizer cases of tests/test_torch_native_plan.py (the
    pillar plan on their x/y cells with one z cell); with GTs the
    assignment / targets against the host ones;
  * every scatter of the builders sends its dropped items to one scratch
    row and no other target twice (so no output depends on which duplicate
    a scatter keeps, which CUDA does not fix).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.data import synthetic_kitti_batch
from robustpointclouds_tpu.data.nuscenes import synthetic_nuscenes_batch
from robustpointclouds_tpu.models import centerpoint as jcp
from robustpointclouds_tpu.models import pointpillars as jpp
from robustpointclouds_tpu.models import voxelnet as jvn
from robustpointclouds_tpu.ops import sparse as jsp
from robustpointclouds_tpu.ops import voxelize as jvox

from robustpointclouds_tpu_torch.cli.common import tiny_pointpillars_cfg, tiny_voxelnet_cfg
from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
from robustpointclouds_tpu_torch.data.native_plan import build_pillar_plan_native, build_plan_native
from robustpointclouds_tpu_torch.models import centerpoint as tcp
from robustpointclouds_tpu_torch.models import pointpillars as tpp
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.ops import sparse as tsp
from robustpointclouds_tpu_torch.ops import voxelize as tvox
from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointPlanBuilder
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

from test_torch_native_plan import TINY, TRUNCATING

INT32_MAX = np.iinfo(np.int32).max
SUBM = ((1, 3, 3, 3), (1, 1, 1, 1), (0, 1, 1, 1))
DOWN = ((1, 3, 3, 3), (1, 2, 2, 2), (0, 1, 1, 1))
OUT = ((1, 3, 1, 1), (1, 2, 1, 1), (0, 0, 0, 0))
# (batch, z, y, x) grids: SECOND's at B=2 (packed ids), B=12 (past 2^30: JAX's
# wide two-key rank sort) and B=23 (past JAX's wide band, the largest batch
# below the int32 ceiling: the one-query-per-tap forms only)
PACKED = (2, 41, 1600, 1408)
WIDE = (12, 41, 1600, 1408)
BAND = (23, 41, 1600, 1408)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compare(ref, got, path=""):
    if isinstance(ref, dict):
        assert sorted(ref) == sorted(got), (path, sorted(ref), sorted(got))
        for k in ref:
            _compare(ref[k], got[k], f"{path}/{k}")
        return
    if isinstance(ref, (tuple, list)):
        assert len(ref) == len(got), path
        for i, (r, g) in enumerate(zip(ref, got)):
            _compare(r, g, f"{path}/{i}")
        return
    r, g = _np(ref), _np(got)
    assert r.shape == g.shape and r.dtype == g.dtype, (path, r.shape, g.shape, r.dtype, g.dtype)
    np.testing.assert_array_equal(g, r, err_msg=path)


def _random_coords(rng, shape, n_real, n_pad):
    """n_real unique (b, z, y, x) sites clustered in a corner box of each
    sample (so the relations have neighbours) near the top of the id space,
    plus n_pad padding rows (coords -1), in shuffled order."""
    b, d, h, w = shape
    box = (min(d, 8), min(h, 12), min(w, 12))
    c = np.stack([rng.randint(max(b - 3, 0), b, 4 * n_real),
                  rng.randint(d - box[0], d, 4 * n_real),
                  rng.randint(h - box[1], h, 4 * n_real),
                  rng.randint(w - box[2], w, 4 * n_real)], 1)
    c = np.unique(c, axis=0)[:n_real]
    rng.shuffle(c)
    coords = np.concatenate([c, np.full((n_pad, 4), -1)]).astype(np.int32)
    mask = np.arange(len(coords)) < len(c)
    perm = rng.permutation(len(coords))
    return coords[perm], mask[perm]


def _grids(coords, mask, shape):
    jg = jsp.make_grid(jnp.asarray(coords), jnp.asarray(mask), shape)
    tg = tsp.make_grid(torch.from_numpy(coords), torch.from_numpy(mask), shape)
    _compare(tuple(jg[:3]), tuple(tg[:3]), "make_grid")
    return jg, tg


@pytest.fixture(scope="module", params=["packed", "wide"])
def grids(request):
    shape = {"packed": PACKED, "wide": WIDE}[request.param]
    coords, mask = _random_coords(np.random.RandomState(7), shape, 300, 40)
    return (shape,) + _grids(coords, mask, shape)


def test_with_batch_axis_matches_jax():
    rng = np.random.RandomState(0)
    for shape, v in (((41, 1600, 1408), 64), ((496, 432), 50)):
        coords = np.stack([rng.randint(0, s, (3, v)) for s in shape], -1).astype(np.int32)
        mask = rng.rand(3, v) < 0.7
        coords = np.where(mask[..., None], coords, -1).astype(np.int32)
        jg, jo = jax.jit(lambda c, m: jsp.with_batch_axis(c, m, shape))(coords, mask)
        tg, to = tsp.with_batch_axis(torch.from_numpy(coords), torch.from_numpy(mask), shape)
        _compare((jg.flat_ids, jg.coords, jg.mask, jo), (tg.flat_ids, tg.coords, tg.mask, to))
        assert tg.spatial_shape == jg.spatial_shape


def test_with_batch_axis_refuses_the_int32_ceiling():
    coords = torch.zeros((24, 4, 3), dtype=torch.int32)
    mask = torch.ones((24, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="overflows int32"):
        jsp.with_batch_axis(jnp.asarray(coords.numpy()), jnp.asarray(mask.numpy()),
                            (41, 1600, 1408))
    with pytest.raises(ValueError, match="overflows int32"):
        tsp.with_batch_axis(coords, mask, (41, 1600, 1408))


@pytest.mark.parametrize("cap", [16, 200, 400])
def test_sort_unique_matches_jax(cap):
    rng = np.random.RandomState(cap)
    ids = rng.randint(0, 300, 500).astype(np.int32)
    ids[rng.rand(500) < 0.2] = INT32_MAX
    ref = jax.jit(lambda x: jsp.sort_unique(x, cap))(ids)
    _compare(ref, tsp.sort_unique(torch.from_numpy(ids), cap))


def test_lookup_matches_jax(grids):
    shape, jg, tg = grids
    rng = np.random.RandomState(1)
    real = np.asarray(jg.flat_ids)[np.asarray(jg.mask)]
    q = np.concatenate([real, real + 1, rng.randint(0, int(np.prod(shape)), 200),
                        np.full(5, INT32_MAX)]).astype(np.int32).reshape(-1, 5)
    ref = jax.jit(lambda g, x: jsp.lookup(g, x))(jg, q)
    _compare(ref, tsp.lookup(tg, torch.from_numpy(q)))


@pytest.mark.parametrize("form", ["kernel", "offsets"])
def test_submanifold_neighbor_index_matches_jax(grids, form):
    _, jg, tg = grids
    k, s, p = SUBM
    arg = k if form == "kernel" else jsp.kernel_offsets(k)
    ref = jax.jit(lambda g: jsp.neighbor_index(g, g.coords, g.mask, arg, s, p))(jg)
    got = tsp.neighbor_index(tg, tg.coords, tg.mask, arg, s, p)
    _compare(ref, got)
    assert int((got < tg.flat_ids.shape[0]).sum()) > int(tg.mask.sum())  # neighbours found


def test_neighbor_index_past_the_wide_band_matches_jax():
    coords, mask = _random_coords(np.random.RandomState(3), BAND, 200, 20)
    jg, tg = _grids(coords, mask, BAND)
    k, s, p = SUBM
    ref = jax.jit(lambda g: jsp.neighbor_index(g, g.coords, g.mask, k, s, p))(jg)
    _compare(ref, tsp.neighbor_index(tg, tg.coords, tg.mask, k, s, p))


def test_neighbor_xwin_info_matches_jax(grids):
    _, jg, tg = grids
    k, s, p = SUBM
    ref = jax.jit(lambda g: tuple(jsp.neighbor_xwin_info(g, g.coords, g.mask, k, s, p)[:2]))(jg)
    got = tsp.neighbor_xwin_info(tg, tg.coords, tg.mask, k, s, p)
    _compare(ref, (got.rows, got.xvalid))
    # and the x-window form is the dense relation
    _compare(tsp.neighbor_index(tg, tg.coords, tg.mask, k, s, p),
             tsp.xwin_to_index(got.rows, got.xvalid, tg.flat_ids, 3))


@pytest.mark.parametrize("geom,cap", [(DOWN, 400), (DOWN, 60), (OUT, 300), (OUT, 40)])
def test_downsample_with_index_matches_jax(grids, geom, cap):
    """Forward and inverse indices and the output sites (also against JAX's
    downsample_sites), the caps truncating at 60 / 40; the strided relation
    by neighbor_index / xwin and its transpose by inverse_neighbor_index."""
    _, jg, tg = grids
    k, s, p = geom

    def jfn(g):
        og, idx, inv = jsp.downsample_with_index(g, k, s, p, cap)
        sites = jsp.downsample_sites(g, k, s, p, cap)
        fwd = jsp.neighbor_index(g, og.coords, og.mask, k, s, p)
        tr = jsp.inverse_neighbor_index(g, og, jsp.kernel_offsets(k), s, p)
        xw = jsp.xwin_from_index(idx, og.coords, og.mask, k[-1], g.flat_ids.shape[0], s[-1],
                                 p[-1], g.spatial_shape[-1])
        return tuple(og[:3]), idx, inv, tuple(sites[:3]), fwd, tr, (xw.rows, xw.xvalid)

    ref = jax.jit(jfn)(jg)
    og, idx, inv = tsp.downsample_with_index(tg, k, s, p, cap)
    fwd = tsp.neighbor_index(tg, og.coords, og.mask, k, s, p)
    tr = tsp.inverse_neighbor_index(tg, og, tsp.kernel_offsets(k), s, p)
    xw = tsp.xwin_from_index(idx, og.coords, og.mask, k[-1], tg.flat_ids.shape[0], s[-1],
                             p[-1], tg.spatial_shape[-1])
    # the sites of the one candidate sort are JAX's downsample_sites too
    _compare(ref, (tuple(og[:3]), idx, inv, tuple(og[:3]), fwd, tr, (xw.rows, xw.xvalid)))
    _, no_idx, inv2 = tsp.downsample_with_index(tg, k, s, p, cap, forward=False)
    assert no_idx is None and torch.equal(inv2, inv)
    if cap <= 60:  # the cap truncates: every row holds a site, some inputs lose theirs
        assert bool(og.mask.all()) and int((inv == cap).sum()) > 0


# -- whole plans -----------------------------------------------------------------

def _kitti_points(vz, batch_size, num_points, seed):
    b = synthetic_kitti_batch(np.random.RandomState(seed), batch_size=batch_size,
                              num_points=num_points, max_gt=8, num_objects=3,
                              point_range=vz["point_cloud_range"])
    return tuple(np.asarray(x) for x in b)


CASES = [(TINY, 2, 512, 0), (TINY, 3, 700, 1), (TRUNCATING, 2, 4000, 5)]


def _to_numpy(tree):
    return jax.tree_util.tree_map(_np, tree)


@pytest.mark.parametrize("vz_kw,batch_size,num_points,seed", CASES)
def test_voxelize_batch_matches_jax(vz_kw, batch_size, num_points, seed):
    pts, msk = _kitti_points(vz_kw, batch_size, num_points, seed)[:2]
    ref = jax.jit(lambda p, m: jvox.voxelize_batch(p, m, jvox.VoxelizerConfig(**vz_kw)))(
        pts[..., :4], msk)
    got = tvox.voxelize_batch(torch.from_numpy(pts[..., :4]), torch.from_numpy(msk),
                              tvox.VoxelizerConfig(**vz_kw))
    _compare(tuple(ref), tuple(got))
    if vz_kw is TRUNCATING:  # the voxel cap and the slot cap both drop points
        assert int(got.num_points.sum()) < int(msk.sum())
        assert bool(got.voxel_mask.all())


@pytest.mark.parametrize("vz_kw,batch_size,num_points,seed", CASES)
def test_second_plan_matches_jax_and_native(vz_kw, batch_size, num_points, seed):
    cfg = tiny_voxelnet_cfg()._replace(voxelizer=tvox.VoxelizerConfig(**vz_kw))
    jcfg = jvn.VoxelNetConfig(voxelizer=jvox.VoxelizerConfig(**vz_kw),
                              anchor_ranges=cfg.anchor_ranges)
    pts, msk, gtb, gtl, gtm = _kitti_points(vz_kw, batch_size, num_points, seed)
    t = [torch.from_numpy(x) for x in (pts, msk, gtb, gtl, gtm)]
    got = _to_numpy(tvn.build_plan(t[0], t[1], cfg, *t[2:]))
    host = build_plan_native(pts, msk, cfg.voxelizer, 4)
    host["assign"] = tvn.anchor_assign_plan(gtb, gtl, gtm, cfg)
    _compare(host, got)  # native plan + host assignment
    ref = _to_numpy(jax.jit(lambda p, m: jvn.build_plan(p, m, jcfg))(pts, msk))
    got.pop("assign")
    _compare(ref, got)
    assert got["enc"]["down1"]["mask"].sum() > 0 and host["assign"]["pos_mask"].any()


def _pillar_vz(vz_kw):
    """A TINY / TRUNCATING case on pillars: its x/y cells, one z cell."""
    vs = vz_kw["voxel_size"]
    return dict(vz_kw, voxel_size=(vs[0], vs[1], 4.0), max_points_per_voxel=4)


@pytest.mark.parametrize("vz_kw,batch_size,num_points,seed", CASES)
def test_pillar_plan_matches_jax_and_native(vz_kw, batch_size, num_points, seed):
    kw = _pillar_vz(vz_kw)
    cfg = tiny_pointpillars_cfg()._replace(voxelizer=tvox.VoxelizerConfig(**kw))
    jcfg = jpp.PointPillarsConfig(voxelizer=jvox.VoxelizerConfig(**kw))
    pts, msk = _kitti_points(kw, batch_size, num_points, seed)[:2]
    got = _to_numpy(tpp.build_pillar_plan(torch.from_numpy(pts), torch.from_numpy(msk), cfg))
    _compare(build_pillar_plan_native(pts, msk, cfg.voxelizer, 4), got)
    _compare(_to_numpy(jax.jit(lambda p, m: jpp.build_pillar_plan(p, m, jcfg))(pts, msk)), got)


@pytest.mark.parametrize("vz_kw,batch_size,seed", [(TINY, 2, 0), (TRUNCATING, 2, 5)])
def test_centerpoint_plan_matches_jax_and_native(vz_kw, batch_size, seed):
    """Bit-equal to the native plan (targets included). JAX's jitted plan
    keeps down2's forward relation dense where the native and torch plans
    keep it in x-window form: there it must be the same index."""
    cfg, _ = tiny_centerpoint_cfg(tcp.CenterPointConfig())
    cfg = cfg._replace(voxelizer=tvox.VoxelizerConfig(**vz_kw))
    jcfg = jcp.CenterPointConfig()._replace(voxelizer=jvox.VoxelizerConfig(**vz_kw))
    batch, vel = synthetic_nuscenes_batch(np.random.RandomState(seed), batch_size=batch_size,
                                          num_points=2000, max_gt=cfg.head.max_objs,
                                          num_objects=6, point_range=vz_kw["point_cloud_range"])
    args = [np.asarray(x) for x in (batch.points, batch.points_mask, batch.gt_boxes,
                                    batch.gt_labels, batch.gt_mask, vel)]
    got = _to_numpy(tcp.build_centerpoint_plan(*(torch.from_numpy(x) for x in args[:2]), cfg,
                                               *(torch.from_numpy(x) for x in args[2:])))
    _compare(CenterPointPlanBuilder(cfg)(*args), got)
    got.pop("targets")
    ref = _to_numpy(jax.jit(lambda p, m: jcp.build_centerpoint_plan(p, m, jcfg))(*args[:2]))
    d2_ref, d2_got = ref["enc"]["down2"], got["enc"]["down2"]
    fwd = tsp.xwin_to_index(torch.from_numpy(d2_got.pop("rows")),
                            torch.from_numpy(d2_got.pop("xvalid")),
                            torch.from_numpy(got["enc"]["down1"]["ids"]), 3)
    _compare(d2_ref.pop("idx"), fwd, "down2/idx")
    _compare(ref, got)


def test_every_scatter_target_outside_the_scratch_row_is_unique(monkeypatch):
    calls = []
    real = tsp.scatter_set

    def checked(size, index, values, fill):
        idx = index.reshape(-1).long()
        assert bool(((idx >= 0) & (idx <= size)).all())
        kept = idx[idx != size]
        assert kept.numel() == torch.unique(kept).numel(), "a target outside the scratch repeats"
        calls.append(size)
        return real(size, index, values, fill)

    monkeypatch.setattr(tsp, "scatter_set", checked)
    vz = TRUNCATING
    pts, msk = (torch.from_numpy(x) for x in _kitti_points(vz, 2, 4000, 5)[:2])
    tvn.build_plan(pts, msk, tvox.VoxelizerConfig(**vz))
    n_second = len(calls)
    cfg = tiny_pointpillars_cfg()._replace(voxelizer=tvox.VoxelizerConfig(**_pillar_vz(vz)))
    tpp.build_pillar_plan(pts, msk, cfg)
    # voxelize: 5 scatters; the batch merge none; each of the 4 downsamples:
    # the unique sites, inv and the forward transpose; the pillars' cell map
    assert n_second == 5 + 4 * 3 and len(calls) == n_second + 5 + 1
