"""The port's SECOND backbone + FPN neck in train mode against the flax modules.

flax's nn.BatchNorm normalises with the batch mean and biased variance and
updates the running variance with that biased variance (momentum 0.9);
torch's training-mode batch_norm would update it with the unbiased one,
n/(n-1) larger. Outputs and both running stats of every BatchNorm2d must
match, float32 on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from robustpointclouds_tpu.nn import second as jsecond

from robustpointclouds_tpu_torch.nn import second as tsecond
import torch_cpu_threads  # noqa: F401  (a share of the cores for torch under xdist)
import jax_native_libs  # noqa: F401  (JAX's native libraries built once, under a lock)


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])
    sd[f"{prefix}.running_mean"] = np.asarray(s["mean"])
    sd[f"{prefix}.running_var"] = np.asarray(s["var"])


def _backbone_sd(params, stats):
    sd = {}
    for s in range(2):
        for i in range(2):
            name = f"stage{s}_conv{i}"
            sd[f"blocks.{s}.{3 * i}.weight"] = np.asarray(
                params[name]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
            _bn(sd, f"blocks.{s}.{3 * i + 1}", params[name]["BatchNorm_0"],
                stats[name]["BatchNorm_0"])
    return sd


def _neck_sd(params, stats):
    sd = {"deblocks.0.0.weight": np.asarray(params["deblock0_conv"]["kernel"]).transpose(2, 3, 0, 1),
          "deblocks.1.0.weight": np.asarray(
              params["deblock1_deconv"]["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)}
    for i in range(2):
        _bn(sd, f"deblocks.{i}.1", params[f"deblock{i}_bn"], stats[f"deblock{i}_bn"])
    return sd


def _load(module, sd):
    missing = module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                                      for k, v in sd.items()}, strict=False)
    assert not missing.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in missing.missing_keys)


def test_backbone_and_neck_train_mode_match_flax_running_stats():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 6, 6).astype(np.float32) * 2 + 0.5
    jb = jsecond.SECONDBackbone(out_channels=(8, 16), layer_nums=(1, 1), layer_strides=(1, 2))
    jn = jsecond.SECONDFPN(out_channels=(8, 8), upsample_strides=(1, 2))
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    vb = jb.init(jax.random.PRNGKey(1), xj, False)
    outs, ub = jb.apply(vb, xj, True, mutable=["batch_stats"])
    vn = jn.init(jax.random.PRNGKey(2), outs, False)
    fused, un = jn.apply(vn, outs, True, mutable=["batch_stats"])

    tb = tsecond.SECONDBackbone(8, (8, 16), (1, 1), (1, 2))
    tn = tsecond.SECONDFPN((8, 16), (8, 8), (1, 2))
    _load(tb, _backbone_sd(vb["params"], vb["batch_stats"]))
    _load(tn, _neck_sd(vn["params"], vn["batch_stats"]))
    tb.train()
    tn.train()
    with torch.no_grad():
        got = tn(tb(torch.from_numpy(x)))
    # float32 on both sides; flax takes the variance as E[x^2] - mean^2, the
    # port two-pass: 1e-4 covers that rounding through four conv layers
    np.testing.assert_allclose(got.numpy(), np.asarray(fused).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-4)
    ref = {**{f"b.{k}": v for k, v in _backbone_sd(vb["params"], ub["batch_stats"]).items()},
           **{f"n.{k}": v for k, v in _neck_sd(vn["params"], un["batch_stats"]).items()}}
    got_sd = {**{f"b.{k}": v for k, v in tb.state_dict().items()},
              **{f"n.{k}": v for k, v in tn.state_dict().items()}}
    n = 0
    for k, v in got_sd.items():
        if k.endswith(("running_mean", "running_var")):
            # one momentum update from the same batch statistics
            np.testing.assert_allclose(v.numpy(), ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
            n += 1
    assert n == 2 * 6  # four backbone BNs and two neck BNs, both running stats


def test_eval_mode_uses_running_stats():
    bn = tsecond.BatchNorm2d(3)
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.5, -1.0, 2.0]))
        bn.running_var.copy_(torch.tensor([2.0, 0.5, 1.0]))
    bn.eval()
    x = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    ref = (x - bn.running_mean[None, :, None, None]) / torch.sqrt(
        bn.running_var[None, :, None, None] + 1e-3)
    torch.testing.assert_close(bn(x), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(bn.running_var, torch.tensor([2.0, 0.5, 1.0]))
