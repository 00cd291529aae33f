"""Triton sources of the first masked-statistics kernel and its VJP, kept as a yardstick.

No path of the port launches these: kernels/masked_stats.py runs the CUDA
kernels of csrc/masked_stats.cu. chip_smoke.py times this pair (and the
eager MaskedBatchNorm ops that followed it) beside them on the same inputs
as `prev`. This module imports triton at the top, so it is imported only
from inside the launching function, on a machine that has Triton and a card.

Replaces the Pallas kernel `masked_stats`
(robustpointclouds_tpu/kernels/masked_stats.py:113, `_kernel` at :32). The
TPU version carries one accumulator across a grid that runs in order; GPU
blocks run in parallel and in no order, so the reduction is two passes:
  1. `_partials_kernel`: each block reads BLOCK_N rows once and writes its
     own (count, mean, M2) per channel — the centred second moment of the
     block, not a raw sum of squares, so nothing cancels;
  2. `_combine_kernel`: one program merges the partials with Chan's formula,
     chunk by chunk (a chunk's exact merge, then a pairwise merge into the
     running total).
What bounds it: one read of x and the mask; a few flops per byte, so bytes.
The partials are about 1/BLOCK_N of x and stay in L2.

`_bwd_kernel` replaces the analytic VJP `_stats_bwd`
(robustpointclouds_tpu/kernels/masked_stats.py:102), which XLA fuses into
one elementwise pass on the TPU:
    dx = m * (g_mean + 2 * g_var * (x - mean)) / max(cnt, 1)
One program per BLOCK_N rows reads x and the mask once and writes dx once in
x's dtype; the per-channel vectors stay in registers. Bound by bytes (a few
flops per element, no tensor-core work), so Triton issues the same traffic a
CUDA kernel would. A missing g_mean or g_var (HAS_GMEAN / HAS_GVAR = 0)
counts as zero.
"""
import torch
import triton
import triton.language as tl


@triton.jit
def _partials_kernel(x_ptr, m_ptr, cnt_ptr, mean_ptr, m2_ptr, n_rows, n_cols,
                     BLOCK_N: tl.constexpr, BLOCK_C: tl.constexpr):
    pid = tl.program_id(0)
    rows = pid * BLOCK_N + tl.arange(0, BLOCK_N)
    cols = tl.arange(0, BLOCK_C)
    rmask = rows < n_rows
    cmask = cols < n_cols
    valid = tl.load(m_ptr + rows, mask=rmask, other=0).to(tl.float32)
    offs = rows[:, None].to(tl.int64) * n_cols + cols[None, :]
    x = tl.load(x_ptr + offs, mask=rmask[:, None] & cmask[None, :], other=0.0).to(tl.float32)
    cnt = tl.sum(valid, axis=0)
    mean = tl.sum(x * valid[:, None], axis=0) / tl.maximum(cnt, 1.0)
    d = (x - mean[None, :]) * valid[:, None]
    m2 = tl.sum(d * d, axis=0)
    tl.store(cnt_ptr + pid, cnt)
    tl.store(mean_ptr + pid * n_cols + cols, mean, mask=cmask)
    tl.store(m2_ptr + pid * n_cols + cols, m2, mask=cmask)


@triton.jit
def _combine_kernel(cnt_ptr, mean_ptr, m2_ptr, out_mean_ptr, out_var_ptr, out_cnt_ptr,
                    n_parts, n_cols, BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < n_cols
    n_acc = tl.zeros([BLOCK_C], dtype=tl.float32)
    mean_acc = tl.zeros([BLOCK_C], dtype=tl.float32)
    m2_acc = tl.zeros([BLOCK_C], dtype=tl.float32)
    for start in range(0, n_parts, BLOCK_P):
        p = start + tl.arange(0, BLOCK_P)
        pmask = p < n_parts
        c = tl.load(cnt_ptr + p, mask=pmask, other=0.0)
        offs = p[:, None] * n_cols + cols[None, :]
        lmask = pmask[:, None] & cmask[None, :]
        mu = tl.load(mean_ptr + offs, mask=lmask, other=0.0)
        q = tl.load(m2_ptr + offs, mask=lmask, other=0.0)
        # exact merge of this chunk's partials
        nc = tl.sum(c, axis=0)
        mean_c = tl.sum(c[:, None] * mu, axis=0) / tl.maximum(nc, 1.0)
        dm = mu - mean_c[None, :]
        m2_c = tl.sum(q, axis=0) + tl.sum(c[:, None] * dm * dm, axis=0)
        # Chan's pairwise merge into the running total
        n_new = n_acc + nc
        delta = mean_c - mean_acc
        frac = nc / tl.maximum(n_new, 1.0)
        mean_acc = mean_acc + delta * frac
        m2_acc = m2_acc + m2_c + delta * delta * n_acc * frac
        n_acc = n_new
    tl.store(out_mean_ptr + cols, mean_acc, mask=cmask)
    tl.store(out_var_ptr + cols, m2_acc / tl.maximum(n_acc, 1.0), mask=cmask)
    tl.store(out_cnt_ptr + cols, n_acc, mask=cols < 1)


def launch(x, mask_u8, mean, var, cnt, n_rows: int, n_cols: int):
    """Both passes on the current stream; outputs are preallocated float32.

    Triton checks the result of each kernel launch (cuLaunchKernel) and raises on failure.
    """
    block_c = max(triton.next_power_of_2(n_cols), 2)
    block_n = max(16, min(1024, 8192 // block_c))
    n_parts = triton.cdiv(n_rows, block_n)
    part_cnt = torch.empty((n_parts,), dtype=torch.float32, device=x.device)
    part_mean = torch.empty((n_parts, n_cols), dtype=torch.float32, device=x.device)
    part_m2 = torch.empty((n_parts, n_cols), dtype=torch.float32, device=x.device)
    _partials_kernel[(n_parts,)](x, mask_u8, part_cnt, part_mean, part_m2, n_rows, n_cols,
                                 BLOCK_N=block_n, BLOCK_C=block_c, num_warps=4)
    block_p = max(16, min(128, 8192 // block_c))
    _combine_kernel[(1,)](part_cnt, part_mean, part_m2, mean, var, cnt, n_parts, n_cols,
                          BLOCK_P=block_p, BLOCK_C=block_c, num_warps=4)


@triton.jit
def _bwd_kernel(x_ptr, m_ptr, mean_ptr, cnt_ptr, gm_ptr, gv_ptr, dx_ptr, n_rows, n_cols,
                HAS_GMEAN: tl.constexpr, HAS_GVAR: tl.constexpr,
                BLOCK_N: tl.constexpr, BLOCK_C: tl.constexpr):
    pid = tl.program_id(0)
    rows = pid * BLOCK_N + tl.arange(0, BLOCK_N)
    cols = tl.arange(0, BLOCK_C)
    rmask = rows < n_rows
    cmask = cols < n_cols
    lmask = rmask[:, None] & cmask[None, :]
    offs = rows[:, None].to(tl.int64) * n_cols + cols[None, :]
    valid = tl.load(m_ptr + rows, mask=rmask, other=0).to(tl.float32)
    inv_cnt = 1.0 / tl.maximum(tl.load(cnt_ptr), 1.0)
    d = tl.zeros([BLOCK_N, BLOCK_C], dtype=tl.float32)
    if HAS_GMEAN:
        gm = tl.load(gm_ptr + cols, mask=cmask, other=0.0)
        d += gm[None, :]
    if HAS_GVAR:
        x = tl.load(x_ptr + offs, mask=lmask, other=0.0).to(tl.float32)
        mean = tl.load(mean_ptr + cols, mask=cmask, other=0.0)
        gv = tl.load(gv_ptr + cols, mask=cmask, other=0.0)
        d += 2.0 * gv[None, :] * (x - mean[None, :])
    dx = valid[:, None] * d * inv_cnt
    tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=lmask)


def launch_bwd(x, mask_u8, mean, cnt, g_mean, g_var, dx, n_rows: int, n_cols: int):
    """dx (preallocated in x's dtype) on the current stream; g_mean / g_var may be None."""
    block_c = max(triton.next_power_of_2(n_cols), 2)
    block_n = max(16, min(1024, 8192 // block_c))
    _bwd_kernel[(triton.cdiv(n_rows, block_n),)](
        x, mask_u8, mean, cnt, mean if g_mean is None else g_mean,
        mean if g_var is None else g_var, dx, n_rows, n_cols,
        HAS_GMEAN=g_mean is not None, HAS_GVAR=g_var is not None,
        BLOCK_N=block_n, BLOCK_C=block_c, num_warps=4)
