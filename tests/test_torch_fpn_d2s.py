"""The JAX package's FPN deblock as a 1x1 product + depth-to-space
(RPC_FPN_D2S, `_DeconvD2S`) against the port's ConvTranspose2d, on the CPU.

The port's stride-s deblock is ConvTranspose2d on every path: the
depth-to-space form sums the same products in another order and is the
slower one on the H100 (chip_smoke.py phase 16 (b)), so the gate is held by
this test rather than ported as code. Held at the JAX package's tolerance
for the same comparison (tests/test_nn.py::test_fpn_d2s_matches_conv_transpose:
rtol 1e-5, atol 1e-6, float32):
  * `_DeconvD2S` on a flax kernel against the port's ConvTranspose2d module
    on the weight the port's converters map it to (spatially flipped,
    tests/test_torch_second_bn.py's `_neck_sd`), strides 2 and 4;
  * JAX's SECONDFPN with FPN_D2S set against the port's SECONDFPN on the
    same weights, train and eval mode: the fused output, and in eval mode
    the input gradients of both stages (the train-mode BatchNorm's
    rounding, 1e-4, as tests/test_torch_second_bn.py holds it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu.nn import second as jsecond

from robustpointclouds_tpu_torch.nn import second as tsecond

from test_torch_second_bn import _load, _neck_sd
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)

TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)


def _to_port(kernel):
    """A flax ConvTranspose kernel [s, s, Cin, Cout] as the port's weight."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel)[::-1, ::-1]
                                                 .transpose(2, 3, 0, 1)))


@pytest.mark.parametrize("stride,cin,cout", [(2, 8, 6), (4, 5, 3)])
def test_d2s_matches_conv_transpose(stride, cin, cout):
    rng = np.random.RandomState(stride)
    x = rng.randn(2, 5, 7, cin).astype(np.float32)  # NHWC, JAX's layout
    kernel = rng.randn(stride, stride, cin, cout).astype(np.float32)
    ref = np.asarray(jsecond._DeconvD2S(cout, stride).apply(
        {"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x)))
    m = tsecond.ConvTranspose2d(cin, cout, stride, stride=stride, bias=False)
    with torch.no_grad():
        m.weight.copy_(_to_port(kernel))
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, cout, 5 * stride, 7 * stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_second_fpn_with_d2s_matches_port_neck(train, monkeypatch):
    monkeypatch.setattr(jsecond, "FPN_D2S", True)  # read while the module is applied
    built, real = [], jsecond._DeconvD2S
    monkeypatch.setattr(jsecond, "_DeconvD2S", lambda *a, **k: built.append(a) or real(*a, **k))
    rng = np.random.RandomState(5)
    outs = [rng.randn(2, 6, 6, 8).astype(np.float32), rng.randn(2, 3, 3, 16).astype(np.float32)]
    jn = jsecond.SECONDFPN(out_channels=(8, 8), upsample_strides=(1, 2))
    jouts = [jnp.asarray(o) for o in outs]
    vn = jn.init(jax.random.PRNGKey(2), jouts, False)
    assert built and all(a[1] == 2 for a in built)  # the stride-2 deblock took the gate

    def jfwd(xs):
        if train:
            return jn.apply(vn, xs, True, mutable=["batch_stats"])[0]
        return jn.apply(vn, xs, False)

    ref, vjp = jax.vjp(jfwd, jouts)
    tn = tsecond.SECONDFPN((8, 16), (8, 8), (1, 2))
    _load(tn, _neck_sd(vn["params"], vn["batch_stats"]))
    tn.train(train)
    xs = [torch.from_numpy(o.transpose(0, 3, 1, 2)).requires_grad_(True) for o in outs]
    got = tn(xs)
    tol = TRAIN_TOL if train else TOL
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref).transpose(0, 3, 1, 2), **tol)
    if not train:
        g = rng.randn(*np.asarray(ref).shape).astype(np.float32)
        jg = vjp(jnp.asarray(g))[0]
        tg = torch.autograd.grad(got, xs, torch.from_numpy(g.transpose(0, 3, 1, 2)))
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b).transpose(0, 3, 1, 2), **TOL)
