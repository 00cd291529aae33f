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
import os
import re

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


# ---- the redesigned row loop and one-hot product: launch plans, the
# one-hot kernel's integer planes, its bound

TROUBLE = [(512, 128, 256), (1001, 3, 1001), (96, 72, 1001), (777, 36, 4099),
           (96000, 64, 864000), (5000, 8, 2_300_000), (1, 1, 1), (64, 200, 1)]


@pytest.mark.parametrize("n,c,m", TROUBLE)
@pytest.mark.parametrize("itemsize,align", [(4, 256), (4, 8), (4, 4), (2, 256), (2, 8),
                                            (2, 4), (2, 2)])  # a base is aligned to its element
def test_row_loop_plan(n, c, m, itemsize, align):
    p = g.row_loop_plan(m, c, itemsize, align)
    row_bytes = c * itemsize
    assert p.vec in (16, 8, 4, 2) and row_bytes % p.vec == 0 and align % p.vec == 0
    # the widest vector the row and the base allow
    assert all(row_bytes % v or align % v for v in (16, 8, 4, 2) if v > p.vec)
    assert p.lanes == min(row_bytes // p.vec, 32) and p.lanes * p.slots <= 256
    assert p.slots == 256 // p.lanes
    assert p.rows_per_block % p.slots == 0 and 0 < p.rows_per_block <= g._LOOP_STAGE
    chunks = -(-m // p.rows_per_block)
    assert p.blocks == min(chunks, g._SMS * g._LOOP_BLOCKS_PER_SM)
    if m >= 2 * p.slots:
        assert p.blocks > 1  # the loop no longer runs on one SM
    if m > g._LOOP_STAGE * g._SMS * g._LOOP_BLOCKS_PER_SM:
        assert chunks > p.blocks  # blocks stride over more chunks than the grid


def test_row_loop_plan_of_the_probe_shapes():
    # the probe's small shape: 512-byte float32 rows, a warp each, 8 rows a block
    assert g.row_loop_plan(256, 128, 4) == g.RowLoopPlan(16, 32, 8, 8, 32)
    # SCALE: 128-byte bf16 rows, 8 threads each; about 4 blocks per SM
    assert g.row_loop_plan(864000, 64, 2) == g.RowLoopPlan(16, 8, 32, 1664, 520)
    # 12-byte float32 rows take 4-byte words; 6-byte bf16 rows 2-byte ones
    assert g.row_loop_plan(1001, 3, 4).vec == 4 and g.row_loop_plan(1001, 3, 2).vec == 2


@pytest.mark.parametrize("n,c,m", TROUBLE)
@pytest.mark.parametrize("itemsize,align", [(4, 256), (4, 8), (4, 4), (2, 256), (2, 8),
                                            (2, 4), (2, 2)])
def test_elem_plan(n, c, m, itemsize, align):
    p = g.elem_plan(m, c, itemsize, align)
    row_bytes = c * itemsize
    # a piece never crosses a row end and its load is aligned: the widest
    # such piece
    assert p.piece in (16, 8, 4, 2) and row_bytes % p.piece == 0 and align % p.piece == 0
    assert all(row_bytes % v or align % v for v in (16, 8, 4, 2) if v > p.piece)
    # every thread moves the same number of 16-byte vectors: the most that
    # still leaves each SM _ELEM_BLOCKS_PER_SM blocks; the grid covers the
    # output's bytes, the last block only partly
    assert 1 <= p.vecs <= g._ELEM_VECS
    full = g._SMS * g._ELEM_BLOCKS_PER_SM
    if p.vecs > 1:
        assert p.blocks >= full
    if p.vecs < g._ELEM_VECS:
        assert -(-m * row_bytes // (16 * g._THREADS * (p.vecs + 1))) < full
    per_block = g._THREADS * p.vecs * 16
    assert p.blocks * per_block >= m * row_bytes > (p.blocks - 1) * per_block


def test_elem_plan_of_the_probe_shapes():
    # 512-byte float32 rows and 128-byte bf16 rows: one 16-byte load a
    # vector; the small shape's 8192 vectors one a thread, SCALE's four
    assert g.elem_plan(256, 128, 4) == g.ElemPlan(16, 1, 32)
    assert g.elem_plan(864000, 64, 2) == g.ElemPlan(16, 4, 6750)
    # 12-byte float32 rows take 4-byte pieces, 6-byte bf16 rows 2-byte ones,
    # a base 4 bytes off a 16-byte boundary 4-byte ones
    assert g.elem_plan(1001, 3, 4).piece == 4 and g.elem_plan(1001, 3, 2).piece == 2
    assert g.elem_plan(1001, 64, 2, align=4).piece == 4


def test_gather_plan_constants_match_the_cuda_source():
    # the Python plans and the kernels share these constants
    src = open(os.path.join(os.path.dirname(g.__file__), os.pardir, "csrc",
                            "gather_probe.cu")).read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kThreads"]) == g._THREADS
    assert int(consts["kLoopStage"]) == g._LOOP_STAGE
    assert int(consts["kElemVecs"]) == g._ELEM_VECS
    assert int(consts["kOhTile"]) == g._OH_TILE and int(consts["kOhWarps"]) == g._OH_WARPS


@pytest.mark.parametrize("n,c,m", TROUBLE)
@pytest.mark.parametrize("itemsize", [4, 2])
def test_onehot_plan(n, c, m, itemsize):
    p = g.onehot_plan(m, c, itemsize)
    assert p.planes == (4 if itemsize == 4 else 2)
    assert p.row_warps in (1, 2, 4) and g._OH_WARPS % p.row_warps == 0
    assert p.col_tiles == -(-c // 16) and p.row_tiles == -(-m // (16 * p.row_warps))
    assert p.row_tiles * 16 * p.row_warps >= m > (p.row_tiles - 1) * 16 * p.row_warps
    blocks = p.row_tiles * p.col_tiles
    if p.row_warps > 1:
        assert blocks >= g._SMS  # stacking tiles never leaves an SM without a block
    else:
        assert -(-m // 32) * p.col_tiles < g._SMS  # too few tiles: the warps split k
    assert p.vec == (16 if (c * itemsize) % 16 == 0 else 0)
    assert g.onehot_plan(m, c, itemsize, align=8).vec == 0


def test_onehot_plan_of_the_probe_shape():
    # [256, 128] float32 output: 16 x 8 tiles of 16 x 16, a block of four
    # warps each splitting its k range; four 10-bit planes a float32 word
    assert g.onehot_plan(256, 128, 4) == g.OnehotPlan(1, 16, 8, 16, 4)


def _special_f32(rng):
    x = rng.randn(64, 9).astype(np.float32)
    x *= np.float32(2.0) ** rng.randint(-140, 120, x.shape).astype(np.float32)  # wide exponents
    x[0] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-40, 2.0 ** -149, -2.0 ** -126]
    x[1] = [3.4028235e38, -3.4028235e38, 2.0 ** 127, 1.1754942e-38, 2.0 ** -133, -2.0 ** -134,
            1.0, -1.0, 0.1]
    return x


@pytest.mark.parametrize("values", ["randn", "wide", "specials"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_planes_rebuild_x_bit_exactly(values, dtype):
    rng = np.random.RandomState(3)
    if values == "randn":
        x = rng.randn(300, 17).astype(np.float32)
    elif values == "wide":
        x = _special_f32(rng)[2:]
    else:
        x = _special_f32(rng)[:2]
    xt = torch.from_numpy(x).to(dtype)
    planes = g.onehot_planes(xt)
    assert planes.dtype == torch.float16 and planes.shape[0] == (4 if dtype == torch.float32 else 2)
    # every plane is 1024 + a 10-bit integer: an exact, normal fp16 whose
    # bits are 0x6400 | v, as the kernel makes them
    pf = planes.float()
    assert torch.equal(pf, pf.round()) and pf.min() >= 1024 and pf.max() < 2048
    assert ((planes.view(torch.int16) & ~0x3FF) == 0x6400).all()
    # joining the planes gives back every word, -0, subnormals, Inf and NaN
    # included; a row without a hit sums to 0 and joins to +0
    joined = g.onehot_join(pf, dtype)
    assert not g.onehot_join(torch.zeros_like(pf), dtype).view(
        torch.int32 if dtype == torch.float32 else torch.int16).any()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(joined.view(bits), xt.view(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,m", [(512, 128, 256), (96, 3, 1001), (40, 72, 300)])
def test_onehot_planes_product_is_the_gather(dtype, n, c, m):
    # the kernel's arithmetic: fp16 one-hot x fp16 planes, float32 sums, joined
    rng = np.random.RandomState(5)
    x = rng.randn(n, c).astype(np.float32)
    x[:2, :min(c, 9)] = _special_f32(rng)[:2, :min(c, 9)]
    xt = torch.from_numpy(x).to(dtype)
    idx = rng.randint(0, n + 1, m).astype(np.int32)
    idx[:4] = [0, 1, n, n]
    it = torch.from_numpy(idx)
    got = g.gather_onehot_planes_ref(xt, it)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), g.gather_ref(xt, it).view(bits))  # x[idx] bit for bit
    finite = torch.isfinite(xt).all(0)
    xf = xt.float().abs()
    normal = ((xf >= torch.finfo(torch.float32).tiny) | (xf == 0)).all(0)
    # on finite columns without subnormals it is the float product of the
    # probe's formula (the CPU's bf16 product flushes subnormals to 0)
    assert torch.equal(got[:, finite & normal], g.gather_onehot_ref(xt, it)[:, finite & normal])
    # where the table holds an Inf or NaN the float product gives NaN in
    # every row of that column (0 * Inf); the planes move the words as they are
    if not finite.all():
        product = g.gather_onehot_ref(xt, it)[:, ~finite]
        assert torch.isnan(product[torch.isfinite(g.gather_ref(xt, it)[:, ~finite])]).all()


def test_probe_bound_of_the_onehot_product():
    # [256, 128] float32 out + 256 int32 indices + the whole [512, 128]
    # table, which the dense product reads: 131072 + 1024 + 262144 bytes at
    # 3.35 TB/s = 117.7 ns; 4 planes x 2*256*512*128 operations at 989
    # TFLOP/s (fp16 tensor cores) = 135.7 ns
    n, c, m = probe_gather.SMALL
    _, idx = probe_gather._inputs(probe_gather.SMALL, torch.float32, (0, 1), "cpu")
    assert probe_gather.rows_read("gather_onehot", idx, n) == n
    nbytes = probe_gather.gather_bytes(n, c, m, 4)
    ops = probe_gather.gather_ops("gather_onehot", n, c, m, 4)
    assert nbytes == 394_240 and ops == 4 * 2 * 256 * 512 * 128 == 134_217_728
    ms, by = probe_gather.bound_ms(nbytes, ops)
    assert by == "operations" and ms == pytest.approx(134_217_728 / 989e12 * 1e3)
    assert round(ms * 1e6, 1) == 135.7 and round(nbytes / 3.35e12 * 1e9, 1) == 117.7
    # bfloat16 takes two planes; the copies do no operations
    assert probe_gather.gather_ops("gather_onehot", n, c, m, 2) == 2 * 2 * 256 * 512 * 128
    assert probe_gather.gather_ops("gather_row_loop", n, c, m, 4) == 0.0
    # a product too large for the bytes: operations bound it
    ms2, by2 = probe_gather.bound_ms(1000.0, 1e12)
    assert by2 == "operations" and ms2 == pytest.approx(1e12 / 989e12 * 1e3)


def test_probe_bound_of_the_copies_counts_the_rows_hit():
    # the copies read only the distinct rows their indices hit: the probe's
    # 256 indices drawn from 512 rows hit 207 of them, so 131072 + 1024 +
    # 207 * 512 = 238080 bytes at 3.35 TB/s = 71.07 ns (not the 117.7 of
    # the whole table)
    n, c, m = probe_gather.SMALL
    _, idx = probe_gather._inputs(probe_gather.SMALL, torch.float32, (0, 1), "cpu")
    for kernel in ("gather_rows", "gather_elems", "gather_row_loop"):
        assert probe_gather.rows_read(kernel, idx, n) == 207
    nbytes = probe_gather.gather_bytes(207, c, m, 4)
    assert nbytes == 238_080
    ms, by = probe_gather.bound_ms(nbytes, probe_gather.gather_ops("gather_row_loop", n, c, m, 4))
    assert by == "bytes" and round(ms * 1e6, 2) == 71.07
    # misses (index N, negative) read no row; repeats read theirs once
    hits = torch.tensor([3, 3, n, -1, 0, n - 1, 3], dtype=torch.int32)
    assert probe_gather.rows_read("gather_row_loop", hits, n) == 3
    # SCALE: 864000 indices over 96000 rows hit 95991, 99.99% of the table
    n, c, m = probe_gather.SCALE
    _, ib = probe_gather._inputs(probe_gather.SCALE, torch.bfloat16, (2, 3), "cpu")
    assert probe_gather.rows_read("gather_rows", ib, n) == 95_991
    ms, _ = probe_gather.bound_ms(probe_gather.gather_bytes(95_991, c, m, 2))
    assert round(ms, 6) == 0.037712  # 126.33 MB at 3.35 TB/s
