"""The port's gather probes (kernels/gather.py, tools/probe_gather.py) on the CPU.

The JAX probe kernels are closures inside probe_mosaic_gather.main() that
lower only on a TPU (their VMEM/SMEM block specs), so the plain versions are
held against the formulas those kernels compute: numpy x[idx] (the probe's
own reference, probe_mosaic_gather.py:76, :137-140), jnp.take (k_take, kg),
jnp.take_along_axis on a broadcast index (k_tal), the one-hot product at
HIGHEST precision (k_onehot) and the zero-padded XLA gather of :132, the
probe's yardstick. Every comparison is exact: the copies move the same
words, and the one-hot product sums one non-zero product.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustpointclouds_tpu_torch.kernels import gather as g
from robustpointclouds_tpu_torch.tools import probe_gather

# (table rows, channels, indices, dtype, index N included): the probe's
# small shape, and a small bf16 table of the sparse conv's width with misses
CASES = [(512, 128, 256, "float32", False), (512, 128, 256, "float32", True),
         (96, 64, 1001, "bfloat16", True)]


def _inputs(n, c, m, dtype, with_miss, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c).astype(np.float32)
    idx = rng.randint(0, n + 1 if with_miss else n, m).astype(np.int32)
    if with_miss:
        idx[:3] = n
    xj = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    return xj, xt, idx


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("n,c,m,dtype,with_miss", CASES)
def test_copy_gathers_match_numpy_and_jax(n, c, m, dtype, with_miss):
    xj, xt, idx = _inputs(n, c, m, dtype, with_miss)
    x_pad = np.concatenate([np.asarray(xj, np.float32), np.zeros((1, c), np.float32)])
    ref = x_pad[idx]  # numpy x[idx] over the zero-padded table
    it = torch.from_numpy(idx)
    for fn in (g.gather_rows, g.gather_elems, g.gather_row_loop):
        got = fn(xt, it)
        assert got.dtype == xt.dtype and got.shape == (m, c)
        np.testing.assert_array_equal(_np(got), ref)
    xjp = jnp.concatenate([xj, jnp.zeros((1, c), xj.dtype)], 0)
    ij = jnp.asarray(idx)
    jax_forms = {
        "xla padded gather (:132)": xjp[ij],
        "jnp.take (k_take, kg)": jnp.take(xjp, ij, axis=0),
        "take_along_axis (k_tal)": jnp.take_along_axis(
            xjp, jnp.broadcast_to(ij[:, None], (m, c)), axis=0),
    }
    got = _np(g.gather_ref(xt, it))
    for name, out in jax_forms.items():
        np.testing.assert_array_equal(got, np.asarray(out, np.float32), err_msg=name)


@pytest.mark.parametrize("n,c,m,dtype,with_miss", CASES)
def test_onehot_product_matches_jax(n, c, m, dtype, with_miss):
    xj, xt, idx = _inputs(n, c, m, dtype, with_miss, seed=1)
    # k_onehot's formula: iota compare -> float32 one-hot -> dot at HIGHEST
    oh = (jnp.asarray(idx)[:, None] == jax.lax.broadcasted_iota(jnp.int32, (m, n), 1))
    ref = jnp.dot(oh.astype(jnp.float32), xj.astype(jnp.float32),
                  precision=jax.lax.Precision.HIGHEST)
    got = g.gather_onehot(xt, torch.from_numpy(idx))
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), np.asarray(ref.astype(xj.dtype), np.float32))
    if with_miss:
        assert np.abs(_np(got)[:3]).max() == 0.0  # index N: the zero row


def test_probe_tool_checks_every_variant_on_the_cpu(capsys):
    out = probe_gather.main(["--cpu"])
    assert [r["kernel"] for r in out["small"]] == [
        "gather_rows", "gather_elems", "gather_row_loop", "gather_onehot"]
    assert all(r["max_abs_err"] == 0.0 for r in out["small"]) and out["scale"] == []
    text = capsys.readouterr().out
    assert text.count("[correct]") == 4 and "not measured" in text


def test_probe_bound_of_the_timed_shape():
    # 864000 x 64 bf16 written + 864000 int32 indices + the table read once
    n, c, m = probe_gather.SCALE
    nbytes = probe_gather.gather_bytes(n, c, m, 2)
    assert nbytes == 110_592_000 + 3_456_000 + 12_288_000
    ms, by = probe_gather.bound_ms(nbytes)
    assert by == "bytes" and round(ms, 4) == 0.0377  # 126.3 MB at 3.35 TB/s


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    x = torch.zeros(4, 8, device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    for fn in (g.gather_rows, g.gather_elems, g.gather_row_loop, g.gather_onehot):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, idx)
        assert fn.launches == 0
