"""CenterPoint's pieces against the JAX package's, on the CPU in float32.

The CenterHead (plain and DCN, weights through
tools/convert.center_head_to_state_dict), the deformable conv (the JAX
tests/test_deform_conv.py cases, grouped DCN included), circle NMS and
`topk_nms_3d`, the anchor head's predict with circle NMS, CenterPoint's
losses, and the plain versions of K1 at Cin = 5 and K2 at C = 5 against
the JAX ops, with the zero-padding the card's wrappers put around those
widths replayed on the CPU.

Tolerances, measured first: head outputs within HEAD_RTOL of each map's
largest entry (measured <= 1.5e-6, eval and train, plain and DCN); DCN
within DCN_RTOL of scale (measured <= 3.1e-7; the JAX tests' own bound is
1e-4 absolute); losses 1e-6 relative; kept detections exactly (masks,
labels; the boxes within 1e-5); the sparse conv, its VJP and the
statistics within 1e-6 of scale (measured 4.3e-7 / 1.1e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from robustpointclouds_tpu.kernels import masked_stats as jax_masked_stats
from robustpointclouds_tpu.models import detection as jdet
from robustpointclouds_tpu.nn.center_head import CenterHead as JCenterHead
from robustpointclouds_tpu.nn.deform_conv import DeformConv2d as JDeformConv2d
from robustpointclouds_tpu.nn.deform_conv import torch_dcn_weight_to_params
from robustpointclouds_tpu.ops import losses as jlosses
from robustpointclouds_tpu.ops import nms as jnms
from robustpointclouds_tpu.ops import subm_conv as jsubm

from robustpointclouds_tpu_torch.kernels import masked_stats as km
from robustpointclouds_tpu_torch.kernels import sparse_conv as sc
from robustpointclouds_tpu_torch.models import detection as tdet
from robustpointclouds_tpu_torch.nn.center_head import NUSCENES_TASKS, CenterHead
from robustpointclouds_tpu_torch.nn.deform_conv import (DeformConv2d, bilinear_gather,
                                                        dcn_kernel_to_weight)
from robustpointclouds_tpu_torch.ops import losses as tlosses
from robustpointclouds_tpu_torch.ops import nms as tnms
from robustpointclouds_tpu_torch.tools.convert import center_head_to_state_dict
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)

HEAD_RTOL = 1e-5
DCN_RTOL = 1e-5
LOSS_RTOL = 1e-6
TF32_RTOL = 2e-6


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _randomize_offsets(params, rng, scale=0.3):
    """The JAX DCN's zero-initialised offset convs given random weights, so
    that the sampling really deforms."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if k == "conv_offset":
                out[k] = {n: jnp.asarray(rng.normal(0, scale / np.sqrt(np.size(x)), np.shape(x)),
                                         jnp.float32) for n, x in v.items()}
            elif isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v)
            else:
                out[k] = v
        return out
    return walk(params)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "dcn"])
def jax_head(request):
    """A JAX CenterHead (plain or DCN), its random weights (the DCN's offset
    convs randomised) and running statistics, on one input."""
    use_dcn = request.param
    rng = np.random.RandomState(0)
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    head = JCenterHead(tasks=NUSCENES_TASKS, use_dcn=use_dcn)
    v = jax.jit(lambda z: head.init(jax.random.PRNGKey(1), z, True))(jnp.asarray(x))
    params = _randomize_offsets(jax.tree_util.tree_map(lambda a: a, dict(v["params"])), rng) \
        if use_dcn else v["params"]
    # running statistics of a trained head: means near 0, variances near 1
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.normal(0, 0.2, np.shape(a)) if path[-1].key == "mean"
                                    else rng.uniform(0.5, 1.5, np.shape(a)), jnp.float32),
        v["batch_stats"])
    return use_dcn, head, x, params, stats


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_center_head_matches_jax(jax_head, train):
    use_dcn, head, x, params, stats = jax_head
    jout, _ = jax.jit(lambda p, z: head.apply({"params": p, "batch_stats": stats}, z, train,
                                               mutable=["batch_stats"]))(params, jnp.asarray(x))
    port = CenterHead(in_channels=32, use_dcn=use_dcn).train(train)
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          center_head_to_state_dict(params, stats).items()}, strict=True)
    with torch.no_grad():
        tout = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(tout) == 6
    for t, (g, r) in enumerate(zip(tout, jout)):
        assert sorted(g) == sorted(r) == sorted(["heatmap", "reg", "height", "dim", "rot", "vel"])
        for k in r:
            assert g[k].dtype == torch.float32 and tuple(g[k].shape) == r[k].shape
            assert _rel_err(g[k].numpy(), r[k]) <= HEAD_RTOL, (t, k)
            assert float(np.asarray(r[k]).std()) > 1e-3  # the maps vary over the cells
    if not train:  # the focal prior: every class probability starts below 0.05 on zero input
        with torch.no_grad():
            zero = port(torch.zeros(1, 32, 4, 4))
        assert all(float(torch.sigmoid(o["heatmap"]).max()) < 0.05 for o in zero)


def _jax_dcn(x, cout, groups=1, deform_groups=1, offset_bias=None, seed=0):
    m = JDeformConv2d(cout, groups=groups, deform_groups=deform_groups)
    v = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    if offset_bias is not None:
        v = jax.tree_util.tree_map(lambda a: a, dict(v["params"]))
        v["conv_offset"] = dict(v["conv_offset"])
        v["conv_offset"]["bias"] = jnp.asarray(offset_bias)
        v = {"params": v}
    return m, v


def _port_dcn(v, cin, cout, groups=1, deform_groups=1):
    p = v["params"]
    port = DeformConv2d(cin, cout, groups=groups, deform_groups=deform_groups)
    port.weight.data = dcn_kernel_to_weight(np.asarray(p["kernel"]), groups)
    port.conv_offset.weight.data = torch.from_numpy(
        np.asarray(p["conv_offset"]["kernel"]).transpose(3, 2, 0, 1).copy())
    port.conv_offset.bias.data = torch.from_numpy(np.asarray(p["conv_offset"]["bias"]).copy())
    return port


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_dcn_zero_offsets_equal_plain_conv_and_jax():
    x = np.random.RandomState(0).randn(2, 8, 10, 4).astype(np.float32)
    m, v = _jax_dcn(x, 6)
    port = _port_dcn(v, 4, 6)
    with torch.no_grad():
        out = port(_nchw(x))
        ref = F.conv2d(_nchw(x), port.weight, padding=1)
    assert _rel_err(out.numpy(), ref.numpy()) <= DCN_RTOL
    assert _rel_err(out.permute(0, 2, 3, 1).numpy(), m.apply(v, jnp.asarray(x))) <= DCN_RTOL


def test_dcn_integer_offset_shifts_sampling():
    x = np.random.RandomState(1).randn(1, 6, 8, 3).astype(np.float32)
    bias = np.zeros(18, np.float32)
    bias[1::2] = 1.0  # dx = +1 on all 9 taps
    m, v = _jax_dcn(x, 5, offset_bias=bias)
    port = _port_dcn(v, 3, 5)
    shifted = np.concatenate([x[:, :, 1:], np.zeros_like(x[:, :, :1])], axis=2)
    with torch.no_grad():
        out = port(_nchw(x))
        ref = F.conv2d(_nchw(shifted), port.weight, padding=1)
    # interior columns agree (the borders differ: zero padding against the shift)
    assert _rel_err(out[:, :, 1:-1, 1:-2].numpy(), ref[:, :, 1:-1, 1:-2].numpy()) <= DCN_RTOL
    assert _rel_err(out.permute(0, 2, 3, 1).numpy(), m.apply(v, jnp.asarray(x))) <= DCN_RTOL


def test_bilinear_gather_fractional():
    x = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4, 1)
    out = bilinear_gather(x, torch.full((1, 1, 1, 1), 0.5), torch.full((1, 1, 1, 1), 1.5))
    assert float(out[0, 0, 0, 0, 0]) == 3.5  # (1 + 2 + 5 + 6) / 4
    # corners outside the map contribute zero: half of x[0, 0, 1] alone
    out = bilinear_gather(x, torch.full((1, 1, 1, 1), -0.5), torch.full((1, 1, 1, 1), 1.0))
    assert float(out[0, 0, 0, 0, 0]) == 0.5


def test_dcn_gradients_flow_through_offsets():
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 4, 6, 6).astype(np.float32))
    port = DeformConv2d(4, 4)
    torch.nn.init.normal_(port.weight)
    torch.nn.init.normal_(port.conv_offset.weight, std=0.1)
    port(x).square().sum().backward()
    assert float(port.conv_offset.weight.grad.abs().sum()) > 0
    assert float(port.conv_offset.bias.grad.abs().sum()) > 0


@pytest.mark.parametrize("groups,deform_groups", [(4, 1), (1, 2), (2, 2)])
def test_grouped_dcn_matches_jax_with_random_offsets(groups, deform_groups):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 9, 8).astype(np.float32)
    m, v = _jax_dcn(x, 8, groups=groups, deform_groups=deform_groups)
    v = {"params": _randomize_offsets(dict(v["params"]), rng, scale=1.0)}
    port = _port_dcn(v, 8, 8, groups=groups, deform_groups=deform_groups)
    with torch.no_grad():
        out = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert _rel_err(out, m.apply(v, jnp.asarray(x))) <= DCN_RTOL
    if groups > 1:  # zero offsets: a grouped conv
        port.conv_offset.weight.data.zero_()
        port.conv_offset.bias.data.zero_()
        with torch.no_grad():
            ref = F.conv2d(_nchw(x), port.weight, padding=1, groups=groups)
            assert _rel_err(port(_nchw(x)).numpy(), ref.numpy()) <= DCN_RTOL


@pytest.mark.parametrize("groups", [1, 4])
def test_dcn_weight_bridge_inverts_the_jax_zoo_converter(groups):
    w = np.random.RandomState(4).randn(8, 8 // groups, 3, 3).astype(np.float32)
    back = dcn_kernel_to_weight(torch_dcn_weight_to_params(w, groups=groups), groups)
    np.testing.assert_array_equal(back.numpy(), w)


@pytest.mark.parametrize("n,radius", [(64, 4.0), (200, 1.5)])
def test_circle_nms_matches_jax(n, radius):
    rng = np.random.RandomState(n)
    centers = rng.uniform(-10, 10, (3, n, 2)).astype(np.float32)
    valid = rng.rand(3, n) > 0.2
    keep = tnms.circle_nms(torch.from_numpy(centers), torch.from_numpy(valid), radius)
    ref = jax.vmap(lambda c, v: jnms.circle_nms(c, v, radius))(jnp.asarray(centers),
                                                               jnp.asarray(valid))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref))
    assert 0 < int(keep.sum()) < int(valid.sum())  # suppression happened


@pytest.mark.parametrize("rotate", [True, False], ids=["rotated", "circle"])
def test_topk_nms_3d_matches_jax(rotate):
    rng = np.random.RandomState(5)
    a = 300
    boxes = np.concatenate([rng.uniform(-20, 20, (a, 2)), rng.uniform(-2, 0, (a, 1)),
                            rng.uniform(1, 5, (a, 3)), rng.uniform(-3, 3, (a, 1))], 1)
    boxes = boxes.astype(np.float32)
    scores = rng.rand(a).astype(np.float32)
    labels = rng.randint(0, 3, a).astype(np.int32)
    valid = rng.rand(a) > 0.1
    kw = dict(score_thr=0.2, nms_pre=120, iou_thr=0.1, max_num=40, use_rotate_nms=rotate,
              circle_radius=2.0)
    got = tnms.topk_nms_3d(*(torch.from_numpy(x) for x in (boxes, scores, labels, valid)), **kw)
    ref = jax.jit(lambda *a: jnms.topk_nms_3d(*a, **kw))(
        *(jnp.asarray(x) for x in (boxes, scores, labels, valid)))
    gb, gs, gl, gm = (x.numpy() for x in got)
    rb, rs, rl, rm = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(gm, rm)
    np.testing.assert_array_equal(gl[gm], rl[rm])
    np.testing.assert_array_equal(gs[gm], rs[rm])
    np.testing.assert_array_equal(gb[gm], rb[rm])
    assert gm.sum() > 0


def test_anchor_head_predict_with_circle_nms_matches_jax():
    """use_rotate_nms=False: per-class circle NMS of radius 4 m (JAX
    models/detection.py:200-203)."""
    from robustpointclouds_tpu_torch.cli.common import tiny_voxelnet_cfg

    cfg = tiny_voxelnet_cfg()
    anchors, _ = cfg.make_anchors()
    h, w = cfg.bev_feature_size
    rng = np.random.RandomState(6)
    a_loc = len(cfg.anchor_sizes) * len(cfg.anchor_rotations)
    cls = rng.normal(-1.0, 1.5, (2, h, w, a_loc, 3)).astype(np.float32)
    box = rng.normal(0, 0.3, (2, h, w, a_loc, 7)).astype(np.float32)
    dirs = rng.normal(0, 1, (2, h, w, a_loc, 2)).astype(np.float32)
    tcfg = cfg.head._replace(use_rotate_nms=False)
    jcfg = jdet.AnchorHeadConfig(**{**jdet.AnchorHeadConfig()._asdict(), **tcfg._asdict()})
    got = tdet.anchor_head_predict(*(torch.from_numpy(x) for x in (cls, box, dirs, anchors)), tcfg)
    ref = jax.jit(lambda *a: jdet.anchor_head_predict(*a, jcfg))(
        *(jnp.asarray(x) for x in (cls, box, dirs, anchors)))
    gb, gs, gl, gm = (x.numpy() for x in got)
    rb, rs, rl, rm = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(gm, rm)
    np.testing.assert_array_equal(gl[gm], rl[rm])
    np.testing.assert_allclose(gs[gm], rs[rm], rtol=1e-6)
    np.testing.assert_allclose(gb[gm], rb[rm], rtol=1e-5, atol=1e-5)
    assert gm.sum() > 0


def test_centerpoint_losses_match_jax():
    rng = np.random.RandomState(7)
    logits = rng.normal(-2, 3, (2, 8, 8, 2)).astype(np.float32)
    target = np.clip(rng.rand(2, 8, 8, 2) - 0.3, 0, 1).astype(np.float32)
    target[0, 3, 4, 1] = target[1, 0, 0, 0] = 1.0
    pred = 1 / (1 + np.exp(-logits))
    for fn_t, fn_j, inp in ((tlosses.gaussian_focal_loss_logits,
                             jlosses.gaussian_focal_loss_logits, logits),
                            (tlosses.gaussian_focal_loss, jlosses.gaussian_focal_loss, pred)):
        got = fn_t(torch.from_numpy(inp), torch.from_numpy(target), avg_factor=3.0)
        ref = fn_j(jnp.asarray(inp), jnp.asarray(target), avg_factor=3.0)
        np.testing.assert_allclose(float(got), float(ref), rtol=LOSS_RTOL)
    a, b = rng.randn(4, 5, 10).astype(np.float32), rng.randn(4, 5, 10).astype(np.float32)
    wgt = (rng.rand(4, 5) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(tlosses.l1_loss(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(wgt), 7.0)),
        float(jlosses.l1_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(wgt), 7.0)),
        rtol=LOSS_RTOL)
    for x, y in zip(tlosses.add_sin_difference(torch.from_numpy(a), torch.from_numpy(b)),
                    jlosses.add_sin_difference(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-6)


# ---- K1 at Cin = 5 and K2 at C = 5: plain versions and the wrappers' padding

def _narrow_conv_inputs(seed=8, cout=16):
    """CenterPoint's conv_input on the smoke grid: [N, 5] voxel features of a
    synthetic NuScenes frame pair and the plan's level-0 submanifold index
    [N, 27] (symmetric: idx[i, k] = j <=> idx[j, 26 - k] = i)."""
    from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
    from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
    from robustpointclouds_tpu_torch.data.native_plan import build_plan_native
    from robustpointclouds_tpu_torch.models.centerpoint import CenterPointConfig
    from robustpointclouds_tpu_torch.nn.sparse_encoder import relation_index

    cfg, n_pts = tiny_centerpoint_cfg(CenterPointConfig())
    rng = np.random.RandomState(seed)
    b, _ = synthetic_nuscenes_batch(rng, batch_size=2, num_points=n_pts, max_gt=8,
                                    num_objects=4, point_range=cfg.voxelizer.point_cloud_range)
    plan = build_plan_native(b.points, b.points_mask, cfg.voxelizer, 5)
    idx = relation_index({k: torch.from_numpy(v) for k, v in plan["enc"]["rel0"].items()},
                         torch.from_numpy(plan["grid_ids"])).numpy()
    n = idx.shape[0]
    feats = rng.randn(n, 5).astype(np.float32)
    kernel = (rng.randn(27 * 5, cout) * 0.3).astype(np.float32)
    return feats, kernel, idx


def test_k1_plain_version_at_cin5_matches_jax():
    feats, kernel, idx = _narrow_conv_inputs()
    assert (idx < idx.shape[0]).sum() > idx.shape[0]  # neighbours beyond the centre taps
    got = sc.sparse_conv_ref(*(torch.from_numpy(x) for x in (feats, kernel, idx)))
    ref = jsubm.subm_conv(jnp.asarray(feats), jnp.asarray(kernel), jnp.asarray(idx))
    assert _rel_err(got.numpy(), ref) <= 1e-6
    # d_W and d_feats through the JAX op's VJP against the plain wgrad and the
    # dgrad (the forward on the mirrored, per-tap transposed weight)
    g = np.random.RandomState(9).randn(*got.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda f, w: jsubm.subm_conv(f, w, jnp.asarray(idx)), jnp.asarray(feats),
                     jnp.asarray(kernel))
    jdf, jdw = vjp(jnp.asarray(g))
    dw = sc.sparse_conv_wgrad_ref(torch.from_numpy(feats), torch.from_numpy(g),
                                  torch.from_numpy(idx))
    assert _rel_err(dw.numpy(), jdw) <= 1e-6
    df = sc.sparse_conv_ref(torch.from_numpy(g),
                            sc.backward_kernel(torch.from_numpy(kernel), idx.shape[1], True),
                            torch.from_numpy(idx))
    assert _rel_err(df.numpy(), jdf) <= 1e-6


@pytest.fixture
def fake_card(monkeypatch):
    """The K1/K2 wrappers' card branches on CPU tensors: each launch replaced
    by the plain version, which records the widths it was given and checks
    that the kernels take them (K1: multiples of 4; K2: one of WIDTHS)."""
    widths = []

    def gemm(name, feats, kernel, idx):
        assert feats.shape[1] % 4 == 0 and kernel.shape[1] % 4 == 0
        widths.append((feats.shape[1], kernel.shape[1]))
        return sc.sparse_conv_ref(feats, kernel, idx)

    def wgrad(feats, g, idx):
        assert feats.shape[1] % 4 == 0 and g.shape[1] % 4 == 0
        widths.append((feats.shape[1], g.shape[1]))
        return sc.sparse_conv_wgrad_ref(feats, g, idx)

    def stats(name, x, mask, stream):
        assert x.shape[1] in km.WIDTHS
        widths.append(x.shape[1])
        return km.masked_stats_ref(x, mask)

    def vjp(x, mask, mean, cnt, g_mean, g_var):
        assert x.shape[1] in km.WIDTHS and mean.shape == (x.shape[1],)
        widths.append(x.shape[1])
        return km.masked_stats_bwd_ref(x, mask, mean, cnt, g_mean, g_var)

    monkeypatch.setattr(sc, "_check", lambda *a: None)
    monkeypatch.setattr(sc, "_gather_gemm_tc", gemm)
    monkeypatch.setattr(sc, "_gather_gemm_tf32", gemm)
    monkeypatch.setattr(sc, "_wgrad_tc", wgrad)
    monkeypatch.setattr(km, "_check_rows", lambda *a: None)
    monkeypatch.setattr(km, "_check_channels", lambda *a: None)
    monkeypatch.setattr(km, "_launch_stats", stats)
    monkeypatch.setattr(km, "_launch_stats_vjp", vjp)
    monkeypatch.setattr(km, "_stream", lambda dev: 0)
    return widths


def test_k1_wrappers_pad_cin5_exactly(fake_card):
    feats, kernel, idx = (torch.from_numpy(x) for x in _narrow_conv_inputs())
    n, k = feats.shape[0], idx.shape[1]
    out = sc._gather_gemm(sc.sparse_conv, "sparse_conv", feats, kernel, idx)
    assert torch.equal(out, sc.sparse_conv_ref(feats, kernel, idx))
    # the dgrad writes Cin = 5 columns: its weight's output side is padded
    g = torch.randn(n, 16, generator=torch.Generator().manual_seed(10))
    w_bwd = sc.backward_kernel(kernel, k, True)
    d = sc._gather_gemm(sc.sparse_conv_dgrad, "sparse_conv_dgrad", g, w_bwd, idx)
    assert d.shape == (n, 5) and torch.equal(d, sc.sparse_conv_ref(g, w_bwd, idx))
    dw = sc._wgrad(feats, g, idx)
    assert dw.shape == (k * 5, 16)
    ref = sc.sparse_conv_wgrad_ref(feats, g, idx)
    assert _rel_err(dw.numpy(), ref.numpy()) <= 1e-6
    # 5 -> 8 on the forward's input, on the dgrad's output, on the wgrad's feats
    assert fake_card == [(8, 16), (16, 8), (8, 16)]


def test_k2_wrappers_pad_c5_exactly(fake_card):
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(3000, 5).astype(np.float32))
    mask = torch.from_numpy(rng.rand(3000) > 0.5)
    mean, var, cnt = km._stats_padded(x, mask)
    rm, rv, rc = km.masked_stats_ref(x, mask)
    assert mean.shape == (5,) and float(cnt) == float(rc)
    assert _rel_err(mean.numpy(), rm.numpy()) <= 1e-6 and _rel_err(var.numpy(), rv.numpy()) <= 1e-6
    gm, gv = torch.randn(5), torch.randn(5)
    dx = km._stats_bwd_padded(x, mask, mean, cnt, gm, gv)
    assert dx.shape == (3000, 5)
    ref = km.masked_stats_bwd_ref(x, mask, rm, rc, gm, gv)
    assert _rel_err(dx.numpy(), ref.numpy()) <= 1e-6
    assert fake_card == [8, 8]
    # the 8 widths of SECOND's adversary and every encoder width take no padding
    for c in km.WIDTHS:
        assert km._stats_width(c) == c
    with pytest.raises(ValueError):
        km._stats_width(257)


def test_k2_plain_version_at_c5_matches_jax():
    rng = np.random.RandomState(12)
    # CenterPoint's point features: x, y, z, intensity and the all-zero lag
    x = rng.randn(5000, 5).astype(np.float32) * np.float32([3, 3, 1, 0.5, 0.0])
    mask = rng.rand(5000) > 0.3
    mean, var, cnt = km.masked_stats_ref(torch.from_numpy(x), torch.from_numpy(mask))
    jm, jv, jc = jax_masked_stats(jnp.asarray(x), jnp.asarray(mask))
    assert _rel_err(mean.numpy(), jm) <= 1e-6 and _rel_err(var.numpy(), jv) <= 1e-6
    assert float(cnt) == float(jc) == mask.sum()
    gm, gv = rng.randn(5).astype(np.float32), rng.randn(5).astype(np.float32)
    _, vjp = jax.vjp(lambda z: jax_masked_stats(z, jnp.asarray(mask))[:2],
                     jnp.asarray(x))
    (jdx,) = vjp((jnp.asarray(gm), jnp.asarray(gv)))
    dx = km.masked_stats_bwd_ref(torch.from_numpy(x), torch.from_numpy(mask), mean, cnt,
                                 torch.from_numpy(gm), torch.from_numpy(gv))
    assert _rel_err(dx.numpy(), jdx) <= 1e-6


@pytest.mark.parametrize("cin,cout,k", [(5, 16, 27), (64, 128, 27), (128, 128, 27),
                                        (128, 128, 3)])
def test_k1_float32_route_at_centerpoint_widths_matches_jax(cin, cout, k):
    """The 3xTF32 kernels' arithmetic in plain PyTorch (sparse_conv_3xtf32_ref)
    at CenterPoint's new widths against the JAX float32 conv, on a real
    submanifold index (K = 27) or a random 3-tap one. Cin = 5 runs as the
    card does, zero-padded to 8. The split leaves ~2^-21 of each product
    out and float32 sums over K*Cin products run in another order: within
    TF32_RTOL of the output's scale for contractions up to 27 x 128
    (SECOND's <= 27 x 64 are held to 1e-6 in test_torch_sparse_conv_tf32)."""
    rng = np.random.RandomState(cin + cout + k)
    if k == 27:
        _, _, idx = _narrow_conv_inputs()
    else:
        idx = rng.randint(0, 900, (700, 3)).clip(max=800).astype(np.int32)
    n = int(idx.max())
    feats = rng.randn(n, cin).astype(np.float32)
    kernel = (rng.randn(k * cin, cout) * 0.2).astype(np.float32)
    ref = np.asarray(jsubm.subm_conv(jnp.asarray(feats), jnp.asarray(kernel), jnp.asarray(idx)))
    f, w = torch.from_numpy(feats), torch.from_numpy(kernel)
    if cin % 4:  # the wrapper's padding, as _gather_gemm applies it
        cp = sc._narrow_pad(cin)
        f = sc._pad_cols(f, cp)
        w = sc._pad_cols(w.reshape(k, cin, cout).transpose(1, 2), cp).transpose(1, 2)
        w = w.reshape(k * cp, cout).contiguous()
    got = sc.sparse_conv_3xtf32_ref(f, w, torch.from_numpy(idx))
    assert _rel_err(got.numpy(), ref) <= TF32_RTOL
