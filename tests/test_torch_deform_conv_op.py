"""The deformable conv, the operator rpc::deform_conv2d (kernels/deform_conv.py), on the CPU.

  * its CPU route (the plain twin) against the JAX package's
    nn/deform_conv.DeformConv2d, on random offsets that are fractional and
    reach past every border of the map, for groups {1, 4} x deform_groups
    {1, 2};
  * the card kernel's algorithm (csrc/deform_conv.cu: tiles of 128 pixels,
    contraction chunks of taps and channels, corners clamped before the
    conversion), replayed in torch, against the twin, on ragged maps, other
    kernel sizes, a group wider than a chunk, and non-finite offsets;
  * the route DeformConv2d takes: under no_grad the operator (one call an
    adaptation), with gradients the twin, gradients intact;
  * torch.library.opcheck, and the refusals;
  * the fake under torch.export: a tiny DCN CenterHead and a tiny DCN
    CenterPoint serve export with one rpc::deform_conv2d node an adaptation,
    and the loaded artifact equals the eager one.
The kernel itself against the twin: tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.nn.deform_conv import DeformConv2d as JDeformConv2d

from robustpointclouds_tpu_torch.cli import export as texport
from robustpointclouds_tpu_torch.cli.train_nuscenes_adversarial import tiny_centerpoint_cfg
from robustpointclouds_tpu_torch.data.nuscenes import synthetic_nuscenes_batch
from robustpointclouds_tpu_torch.kernels import deform_conv as kdc
from robustpointclouds_tpu_torch.models import centerpoint as tcp
from robustpointclouds_tpu_torch.models import voxelnet as tvn
from robustpointclouds_tpu_torch.nn.center_head import CenterHead
from robustpointclouds_tpu_torch.nn.deform_conv import DeformConv2d, dcn_kernel_to_weight
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

# float32 against JAX's float32, relative to the output's scale: summation
# order only (tests/test_torch_centerpoint_ops.py measured <= 3.1e-7)
DCN_RTOL = 1e-5
# csrc/deform_conv.cu's tiling, as the replay below mirrors it
TILE_PIXELS, CHUNK_ROWS = 128, 80


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _jax_dcn_with_offsets(rng, x, cout, groups, deform_groups):
    """A JAX DeformConv2d whose offset conv gives offsets of a few cells,
    fractional, plus a bias that throws some taps past the map's borders."""
    _, h, w, _ = x.shape
    m = JDeformConv2d(cout, groups=groups, deform_groups=deform_groups)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree_util.tree_map(lambda a: a, dict(v["params"]))
    ok = p["conv_offset"]["kernel"]
    reach = float(max(h, w) + 2)
    p["conv_offset"] = {
        "kernel": jnp.asarray(rng.normal(0, 1.0 / np.sqrt(np.prod(ok.shape[:3])), ok.shape),
                              jnp.float32),
        "bias": jnp.asarray(rng.uniform(-reach, reach, p["conv_offset"]["bias"].shape),
                            jnp.float32)}
    return m, {"params": p}


def _port_dcn(v, cin, cout, groups, deform_groups):
    p = v["params"]
    port = DeformConv2d(cin, cout, groups=groups, deform_groups=deform_groups)
    port.weight.data = dcn_kernel_to_weight(np.asarray(p["kernel"]), groups)
    port.conv_offset.weight.data = torch.from_numpy(
        np.asarray(p["conv_offset"]["kernel"]).transpose(3, 2, 0, 1).copy())
    port.conv_offset.bias.data = torch.from_numpy(np.asarray(p["conv_offset"]["bias"]).copy())
    return port


@pytest.mark.parametrize("deform_groups", [1, 2])
@pytest.mark.parametrize("groups", [1, 4])
def test_cpu_route_matches_jax(groups, deform_groups):
    rng = np.random.RandomState(10 * groups + deform_groups)
    x = rng.randn(2, 7, 9, 8).astype(np.float32)
    m, v = _jax_dcn_with_offsets(rng, x, 8, groups, deform_groups)
    port = _port_dcn(v, 8, 8, groups, deform_groups)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        off = port.conv_offset(xt)
        before = kdc.KERNEL_LAUNCHES["plain"]
        out = kdc.deform_conv2d(xt, off, port.weight, groups, deform_groups)
    assert kdc.KERNEL_LAUNCHES["plain"] == before + 1
    # the sampling deforms: fractional offsets, and taps past each of the four borders
    k2 = off.reshape(2, deform_groups, 9, 2, 7, 9)
    dy, dx = k2[:, :, :, 0], k2[:, :, :, 1]
    assert float((dy - dy.round()).abs().mean()) > 0.1
    gy = torch.arange(7).view(7, 1) + torch.arange(-1, 2).repeat_interleave(3).view(9, 1, 1)
    gx = torch.arange(9).view(1, 9) + torch.arange(-1, 2).repeat(3).view(9, 1, 1)
    py, px = gy + dy, gx + dx
    assert bool((py < -1).any() and (py > 7).any() and (px < -1).any() and (px > 9).any())
    ref = m.apply(v, jnp.asarray(x))
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    assert _rel_err(out.permute(0, 2, 3, 1).numpy(), ref) <= DCN_RTOL


def _chunk_taps(channels_a_group, taps):
    """csrc/deform_conv.cu chunk_taps_for."""
    fit = CHUNK_ROWS // channels_a_group
    if fit <= 1:
        return 1
    chunks = -(-taps // fit)
    return -(-taps // chunks)


def _kernel_replay(x, offset, weight, groups, deform_groups):
    """csrc/deform_conv.cu's algorithm in torch: a tile of 128 flattened
    pixels, each conv group's rows (tap, channel) a chunk at a time, corners
    computed once a (tap, deform group) with y0 / x0 clamped to [-2, H] /
    [-2, W] before the conversion and validity taken on the integers,
    weights (1 - wy)(1 - wx) ... applied to every channel of the chunk."""
    b, c, h, w = x.shape
    cout, cg, k, _ = weight.shape
    kk, pad, og, cdg = k * k, (k - 1) // 2, cout // groups, c // deform_groups
    hw = h * w
    chunk_taps = _chunk_taps(cg, kk)
    out = torch.full((b, cout, hw), float("nan"))
    xf, of = x.reshape(b, c, hw), offset.reshape(b, -1, hw)
    wf = weight.reshape(cout, cg * kk)
    rows_seen = []
    for p0 in range(0, hw, TILE_PIXELS):
        p = torch.arange(p0, min(p0 + TILE_PIXELS, hw))
        ph, pw = p // w, p % w
        for gi in range(groups):
            acc = torch.zeros(b, og, len(p))
            for t0 in range(0, kk, chunk_taps):
                tc = min(chunk_taps, kk - t0)
                for c0 in range(0, cg, CHUNK_ROWS):
                    cc = min(cg - c0, CHUNK_ROWS // tc)
                    assert tc * cc <= CHUNK_ROWS
                    col, wts = torch.zeros(b, tc * cc, len(p)), torch.zeros(og, tc * cc)
                    for tl in range(tc):
                        t = t0 + tl
                        for cl in range(cc):
                            ch = gi * cg + c0 + cl
                            d = ch // cdg
                            py = (ph + t // k - pad).float() + of[:, (d * kk + t) * 2, p]
                            px = (pw + t % k - pad).float() + of[:, (d * kk + t) * 2 + 1, p]
                            y0, x0 = torch.floor(py), torch.floor(px)
                            wy, wx = py - y0, px - x0
                            yi = torch.nan_to_num(y0, nan=-2.0).clamp(-2, h).long()
                            xi = torch.nan_to_num(x0, nan=-2.0).clamp(-2, w).long()
                            s = torch.zeros(b, len(p))
                            for dy, dx, wt in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                                               (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
                                yy, xx = yi + dy, xi + dx
                                ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                                idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))
                                v = torch.where(ok, torch.gather(xf[:, ch], 1, idx),
                                                torch.zeros(()))
                                s = s + v * wt
                            col[:, tl * cc + cl] = s
                            wts[:, tl * cc + cl] = wf[gi * og:(gi + 1) * og, (c0 + cl) * kk + t]
                            rows_seen.append((p0, gi, ch, t))
                    acc += torch.einsum("or,brp->bop", wts, col)
            out[:, gi * og:(gi + 1) * og, p] = acc
    # every (tile, group's channel, tap) row taken exactly once
    tiles = -(-hw // TILE_PIXELS)
    assert len(rows_seen) == len(set(rows_seen)) == tiles * c * kk
    return out.reshape(b, cout, h, w)


@pytest.mark.parametrize("shape,cout,k,groups,deform_groups", [
    ((2, 64, 9, 20), 64, 3, 4, 1),   # CenterPoint's head widths on a small, ragged map
    ((1, 8, 16, 16), 8, 3, 2, 2),    # two tiles exactly
    ((2, 6, 5, 7), 9, 3, 3, 3),      # 35 pixels: one partial tile
    ((1, 96, 4, 3), 32, 3, 1, 1),    # 96 channels a group: one tap a chunk, channels split
    ((1, 4, 11, 13), 4, 5, 1, 2),    # 5x5 taps
    ((1, 5, 6, 7), 10, 1, 5, 1),     # 1x1
])
def test_kernel_replay_matches_twin(shape, cout, k, groups, deform_groups):
    g = torch.Generator().manual_seed(sum(shape) + k)
    b, c, h, w = shape
    x = torch.randn(shape, generator=g)
    offset = torch.randn(b, deform_groups * 2 * k * k, h, w, generator=g) * 2.5
    offset[:, ::3] += float(h)  # some taps past the far border
    offset[:, 1::4] -= float(w)  # and the near one
    weight = torch.randn(cout, c // groups, k, k, generator=g)
    ref = kdc.deform_conv2d_ref(x, offset, weight, groups, deform_groups)
    got = _kernel_replay(x, offset, weight, groups, deform_groups)
    assert _rel_err(got.numpy(), ref.numpy()) <= DCN_RTOL


def test_kernel_replay_non_finite_offsets():
    """A NaN or infinite offset gives NaN outputs at its own pixel (its
    bilinear weights are NaN; the twin's gather cannot index there), and
    every other pixel is the twin's."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 4, 6, 5, generator=g)
    offset = torch.randn(1, 18, 6, 5, generator=g)
    weight = torch.randn(4, 4, 3, 3, generator=g)
    ref = kdc.deform_conv2d_ref(x, offset, weight, 1, 1)
    offset[0, 4, 2, 3] = float("nan")
    offset[0, 7, 4, 1] = float("inf")
    offset[0, 10, 0, 0] = -float("inf")
    got = _kernel_replay(x, offset, weight, 1, 1)
    bad = torch.zeros_like(ref, dtype=torch.bool)
    bad[0, :, 2, 3] = bad[0, :, 4, 1] = bad[0, :, 0, 0] = True
    assert torch.equal(torch.isnan(got), bad)
    assert _rel_err(got[~bad].numpy(), ref[~bad].numpy()) <= DCN_RTOL


def _random_dcn(cin, cout, groups=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    m = DeformConv2d(cin, cout, groups=groups)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.3)
        m.conv_offset.weight.copy_(torch.randn(m.conv_offset.weight.shape, generator=g) * 0.2)
        m.conv_offset.bias.copy_(torch.randn(m.conv_offset.bias.shape, generator=g))
    return m


def test_route_no_grad_takes_the_operator_grad_takes_the_twin(monkeypatch):
    m = _random_dcn(8, 8)
    x = torch.randn(2, 8, 6, 7, generator=torch.Generator().manual_seed(1))
    calls = []
    orig = kdc.deform_conv2d_ref
    monkeypatch.setattr("robustpointclouds_tpu_torch.nn.deform_conv.deform_conv2d_ref",
                        lambda *a: calls.append("twin") or orig(*a))
    before = kdc.KERNEL_LAUNCHES["plain"]
    with torch.no_grad():
        want = m(x)
    assert kdc.KERNEL_LAUNCHES["plain"] == before + 1 and calls == []
    with torch.inference_mode():
        assert torch.equal(m(x), want)
    assert kdc.KERNEL_LAUNCHES["plain"] == before + 2 and calls == []
    # gradients: the twin, the operator untouched
    xg = x.clone().requires_grad_(True)
    got = m(xg)
    assert calls == ["twin"] and kdc.KERNEL_LAUNCHES["plain"] == before + 2
    assert got.requires_grad and torch.equal(got.detach(), want)
    got.square().sum().backward()
    for t in (xg.grad, m.weight.grad, m.conv_offset.weight.grad, m.conv_offset.bias.grad):
        assert t is not None and float(t.abs().sum()) > 0
    # grad mode on, the input without a gradient: the parameters still need one
    m.zero_grad()
    m(x).sum().backward()
    assert calls == ["twin", "twin"] and float(m.conv_offset.weight.grad.abs().sum()) > 0
    # frozen parameters and an input without a gradient: nothing to differentiate
    for prm in m.parameters():
        prm.requires_grad_(False)
    assert torch.equal(m(x), want)
    assert calls == ["twin", "twin"] and kdc.KERNEL_LAUNCHES["plain"] == before + 3


def test_dcn_center_head_calls_the_operator_once_an_adaptation():
    head = CenterHead(in_channels=16, use_dcn=True).eval()
    x = torch.randn(1, 16, 8, 8)
    before = kdc.KERNEL_LAUNCHES["plain"]
    with torch.no_grad():
        head(x)
    assert kdc.KERNEL_LAUNCHES["plain"] == before + 2 * len(head.task_heads) == before + 12
    head(x)  # a gradient to carry: the twin, outside the operator
    assert kdc.KERNEL_LAUNCHES["plain"] == before + 12


@pytest.mark.parametrize("bad", ["dtype", "offset_shape", "weight_groups", "not_4d", "meta"])
def test_operator_rejects_what_it_cannot_take(bad):
    x, off, wt = torch.zeros(1, 8, 4, 4), torch.zeros(1, 18, 4, 4), torch.zeros(8, 2, 3, 3)
    args = [x, off, wt, 4, 1]
    if bad == "dtype":
        args[1] = off.double()
    elif bad == "offset_shape":
        args[1] = torch.zeros(1, 36, 4, 4)
    elif bad == "weight_groups":
        args[3] = 2
    elif bad == "not_4d":
        args[0] = x[0]
    else:  # a meta tensor would get the fake's empty output
        args[:3] = [t.to("meta") for t in args[:3]]
    with pytest.raises((TypeError, ValueError)):
        kdc.deform_conv2d(*args)


@pytest.mark.parametrize("groups,deform_groups", [(4, 1), (1, 2)])
def test_opcheck(groups, deform_groups):
    g = torch.Generator().manual_seed(groups)
    x = torch.randn(2, 8, 5, 6, generator=g)
    off = torch.randn(2, deform_groups * 18, 5, 6, generator=g) * 2
    wt = torch.randn(8, 8 // groups, 3, 3, generator=g)
    torch.library.opcheck(kdc.deform_conv2d_op, (x, off, wt, groups, deform_groups))


def _randomize_offsets(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DeformConv2d):
                m.conv_offset.weight.copy_(torch.randn(m.conv_offset.weight.shape, generator=g)
                                           * 0.05)
                m.conv_offset.bias.copy_(torch.randn(m.conv_offset.bias.shape, generator=g))


def _nodes(ep):
    return sum(str(n.target) == "rpc.deform_conv2d.default" for n in ep.graph.nodes
               if n.op == "call_function")


def test_export_dcn_head_records_the_operator(tmp_path):
    head = CenterHead(in_channels=16, use_dcn=True).eval()
    tvn.init_weights(head, torch.Generator().manual_seed(0))
    _randomize_offsets(head, 1)
    x = torch.randn(2, 16, 8, 8, generator=torch.Generator().manual_seed(2))
    before = kdc.KERNEL_LAUNCHES["plain"]
    with torch.no_grad():
        want = head(x)
        ep = torch.export.export(head, (torch.zeros_like(x),), strict=False)
    assert kdc.KERNEL_LAUNCHES["plain"] == before + 12  # tracing runs the fake
    assert _nodes(ep) == 12
    path = str(tmp_path / "head.pt2")
    torch.export.save(ep, path)
    got = torch.export.load(path).module()(x)
    assert kdc.KERNEL_LAUNCHES["plain"] == before + 24
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert torch.equal(g[key], w[key]), key


def test_export_dcn_centerpoint_serve_records_the_operator(tmp_path):
    cfg, npts = tiny_centerpoint_cfg(tcp.CenterPointConfig(compute_dtype="float32",
                                                           use_dcn_head=True))
    model = tcp.AdversarialCenterPoint(cfg)
    tvn.init_weights(model, torch.Generator().manual_seed(0))
    _randomize_offsets(model, 3)
    frames = synthetic_nuscenes_batch(np.random.RandomState(2), batch_size=2, num_points=npts,
                                      max_gt=cfg.head.max_objs,
                                      point_range=cfg.voxelizer.point_cloud_range)[0]
    pts, msk = np.asarray(frames.points), np.asarray(frames.points_mask)
    head = cfg.head._replace(score_thr=0.0)
    serve = texport.export_serving(model, None, None, head, device="cpu")
    before = kdc.KERNEL_LAUNCHES["plain"]
    want = serve(pts, msk)
    assert kdc.KERNEL_LAUNCHES["plain"] == before + 12
    ep, meta = texport.export_program(model, None, head, 2, npts, device="cpu")
    assert _nodes(ep) == 12 and kdc.KERNEL_LAUNCHES["plain"] == before + 12
    path = str(tmp_path / "centerpoint_dcn.pt2")
    texport.save_exported(ep, meta, path)
    call, _ = texport.load_exported(path)
    got = call(torch.from_numpy(pts), torch.from_numpy(msk))
    assert kdc.KERNEL_LAUNCHES["plain"] == before + 24
    assert int(want[3].sum()) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
