"""Sparse-conv gather-GEMMs: the port of the Pallas `mp_gather_conv` (`out`, `bwd`, `col` modes).

`sparse_conv(feats, kernel, idx)` computes, for every output row i,
    out[i] = sum_k feats_pad[idx[i, k]] @ kernel[k*Cin:(k+1)*Cin]
with idx [M, K] in [0, N] (N = miss, reads a zero row), kernel [K*Cin, Cout]
in the JAX img2col order, float32 accumulation and the output in feats'
dtype — the contract of robustpointclouds_tpu/ops/subm_conv.subm_conv and
strided_conv_t's forward. One kernel serves every one of the 12 encoder
convs: the plan's x-window and inverse layouts are converted to this dense
index first (ops/sparse.py).

The backward mirrors the JAX custom VJPs (ops/subm_conv.py):
  * d_feats (`sparse_conv_dgrad`, the counterpart of the `bwd` mode) is the
    same gather-GEMM on the output cotangent g with per-tap transposed
    weights [K*Cout, Cin] over a backward index. For a strided conv that
    index is the plan's inverse `inv` [N, K] (miss = M). For a submanifold
    conv the relation is symmetric (idx[i, k] = j <=> idx[j, K-1-k] = i), so
    the backward index is the forward one read with mirrored taps; the port
    mirrors the small weight instead of the index — tap k of the transposed
    weight holds W_{K-1-k}^T — which gives the same sum over taps without a
    flag in the kernel and without a reversed copy of the [N, 27] index;
  * d_W (`sparse_conv_wgrad`, the counterpart of the `col` mode plus its
    einsum) is dW[k*Cin + c, o] = sum_i feats_pad[idx[i, k], c] * g[i, o]
    over the forward index, accumulated in float32 and returned in float32
    for the float32 parameter.
`SparseConvFunction` wraps the three as one autograd Function.

A CUDA tensor launches the hand-written kernels (csrc/sparse_conv.cu, built
on first use); a CPU tensor takes the plain PyTorch versions
(`sparse_conv_ref`, `sparse_conv_wgrad_ref`), which the CPU tests hold
against the JAX ops. Anything else raises. Each wrapper counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256
_WGRAD_MAX_PAIRS = 8192  # Cin*Cout: 32 float32 accumulators per thread
_WGRAD_SMEM_FLOATS = 12288  # the staged hits: cap * (Cin + Cout) floats (48 KiB)
_WGRAD_MAX_CAP = 512
_WGRAD_SMS = 132  # an H100's SMs; the grid aims at a few resident blocks on each


def sparse_conv_ref(feats: torch.Tensor, kernel: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: img2col gather + one float32 matmul."""
    n, c = feats.shape
    feats_pad = torch.cat([feats, feats.new_zeros(1, c)], 0)
    col = feats_pad[idx.long()].reshape(idx.shape[0], idx.shape[1] * c)
    return (col.float() @ kernel.float()).to(feats.dtype)


def sparse_conv_wgrad_ref(feats: torch.Tensor, g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of d_W: img2col gather, then col^T @ g in float32."""
    n, c = feats.shape
    feats_pad = torch.cat([feats, feats.new_zeros(1, c)], 0)
    col = feats_pad[idx.long()].reshape(idx.shape[0], idx.shape[1] * c)
    return col.float().t() @ g.float()


def backward_kernel(kernel: torch.Tensor, k: int, mirror: bool) -> torch.Tensor:
    """[K*Cin, Cout] -> the dgrad weight [K*Cout, Cin]: each tap transposed,
    taps in reverse order when `mirror` (submanifold convs)."""
    kcin, cout = kernel.shape
    w = kernel.reshape(k, kcin // k, cout)
    if mirror:
        w = w.flip(0)
    return w.transpose(1, 2).reshape(k * cout, kcin // k).contiguous()


def _lib() -> ctypes.CDLL:
    lib = load_library("sparse_conv")
    fwd = lib.rpc_sparse_conv_fwd
    if fwd.argtypes is None:  # pointers and the stream must not pass as 32-bit ints
        fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        wg = lib.rpc_sparse_conv_wgrad
        wg.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        wg.restype = ctypes.c_int
    return lib


def _check(name, feats, other, idx):
    if not (feats.is_cuda and other.device == feats.device and idx.device == feats.device):
        raise ValueError(f"{name}: all inputs must lie on one CUDA device")
    if feats.dtype not in _DTYPE_CODES or other.dtype != feats.dtype:
        raise TypeError(f"{name}: inputs must share float32 or bfloat16, "
                        f"got {feats.dtype}/{other.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {idx.dtype}")
    if feats.dim() != 2 or idx.dim() != 2 or other.dim() != 2:
        raise ValueError(f"{name}: 2-D inputs expected")
    if not (feats.is_contiguous() and other.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def _launch_gather_gemm(name, feats, kernel, idx):
    _check(name, feats, kernel, idx)
    m, k = idx.shape
    cin, cout = feats.shape[1], kernel.shape[1]
    if kernel.shape[0] != k * cin:
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} does not match "
                         f"K={k} taps of Cin={cin}")
    if cout > _THREADS or _THREADS % cout != 0:
        raise ValueError(f"{name}: Cout={cout} must divide {_THREADS}")
    out = torch.empty((m, cout), dtype=feats.dtype, device=feats.device)
    rc = _lib().rpc_sparse_conv_fwd(
        feats.data_ptr(), kernel.data_ptr(), idx.data_ptr(), out.data_ptr(),
        feats.shape[0], m, k, cin, cout,
        _DTYPE_CODES[feats.dtype], torch.cuda.current_stream(feats.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    return out


def sparse_conv(feats: torch.Tensor, kernel: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats [N, Cin], kernel [K*Cin, Cout], idx [M, K] int32 -> [M, Cout]."""
    if feats.device.type == "cpu":
        return sparse_conv_ref(feats, kernel, idx)
    out = _launch_gather_gemm("sparse_conv", feats, kernel, idx)
    sparse_conv.launches += 1
    return out


def sparse_conv_dgrad(g: torch.Tensor, kernel_bwd: torch.Tensor, bwd_idx: torch.Tensor) -> torch.Tensor:
    """d_feats [N, Cin] from g [M, Cout], kernel_bwd [K*Cout, Cin] (see
    `backward_kernel`) and the backward index [N, K] in [0, M] (M = miss).

    The forward's gather-GEMM kernel, launched and counted on its own."""
    if g.device.type == "cpu":
        return sparse_conv_ref(g, kernel_bwd, bwd_idx)
    out = _launch_gather_gemm("sparse_conv_dgrad", g, kernel_bwd, bwd_idx)
    sparse_conv_dgrad.launches += 1
    return out


def _wgrad_grid(m: int, k: int, cin: int, cout: int) -> tuple:
    """(rows per chunk, chunks, cap) of the wgrad launch. cap: the most
    hits staged per barrier, the largest power of two whose gathered rows
    fit _WGRAD_SMEM_FLOATS. The (chunk, tap) grid aims at 8 blocks per SM
    when the [Cin, Cout] partial is small (narrow convs: their time goes to
    scanning the index) and 4 otherwise (fewer partials to write and sum);
    rows per chunk are a multiple of the 256 rows of the longest scan step."""
    cap = _WGRAD_MAX_CAP
    while cap > 2 and cap * (cin + cout) > _WGRAD_SMEM_FLOATS:
        cap //= 2
    target = _WGRAD_SMS * (8 if cin * cout <= 1024 else 4)
    chunks = min(max(1, -(-target // k)), max(1, -(-m // _THREADS)))
    rows = -(-max(m, 1) // chunks)
    rows = -(-rows // _THREADS) * _THREADS
    return rows, -(-max(m, 1) // rows), cap


def sparse_conv_wgrad(feats: torch.Tensor, g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """d_W [K*Cin, Cout] float32 from feats [N, Cin], g [M, Cout] and the
    forward index [M, K]."""
    if feats.device.type == "cpu":
        return sparse_conv_wgrad_ref(feats, g, idx)
    _check("sparse_conv_wgrad", feats, g, idx)
    m, k = idx.shape
    cin, cout = feats.shape[1], g.shape[1]
    pairs = cin * cout
    if g.shape[0] != m:
        raise ValueError(f"sparse_conv_wgrad: g has {g.shape[0]} rows, idx {m}")
    if cout > _THREADS or _THREADS % cout != 0:
        raise ValueError(f"sparse_conv_wgrad: Cout={cout} must divide {_THREADS}")
    if pairs > _WGRAD_MAX_PAIRS or pairs & (pairs - 1):
        raise ValueError(f"sparse_conv_wgrad: Cin*Cout={pairs} must be a power of two "
                         f"and at most {_WGRAD_MAX_PAIRS}")
    rows, chunks, cap = _wgrad_grid(m, k, cin, cout)
    partial = torch.empty((chunks, k * pairs), dtype=torch.float32, device=feats.device)
    dw = torch.empty((k * cin, cout), dtype=torch.float32, device=feats.device)
    rc = _lib().rpc_sparse_conv_wgrad(
        feats.data_ptr(), g.data_ptr(), idx.data_ptr(), partial.data_ptr(), dw.data_ptr(),
        feats.shape[0], m, k, cin, cout, rows, chunks, cap,
        _DTYPE_CODES[feats.dtype], torch.cuda.current_stream(feats.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"sparse_conv_wgrad: kernel launch failed with cudaError {rc}")
    sparse_conv_wgrad.launches += 1
    return dw


sparse_conv.launches = 0
sparse_conv_dgrad.launches = 0
sparse_conv_wgrad.launches = 0


class SparseConvFunction(torch.autograd.Function):
    """out = sparse_conv(feats, weight.to(feats.dtype), idx) with the
    gather-only backward of the JAX custom VJPs.

    weight: [K*Cin, Cout] float32 (the parameter's img2col view); its
    gradient stays float32. bwd_idx: the backward index (the forward index
    itself for a submanifold conv, `mirror=True`; the inverse index `inv`
    [N, K] for a strided one).
    """

    @staticmethod
    def forward(ctx, feats, weight, idx, bwd_idx, mirror: bool):
        kernel = weight.to(feats.dtype).contiguous()
        ctx.save_for_backward(feats, kernel, idx, bwd_idx)
        ctx.mirror = mirror
        return sparse_conv(feats, kernel, idx)

    @staticmethod
    def backward(ctx, g):
        feats, kernel, idx, bwd_idx = ctx.saved_tensors
        g = g.contiguous()
        d_feats = d_w = None
        if ctx.needs_input_grad[0]:
            w_bwd = backward_kernel(kernel, idx.shape[1], ctx.mirror)
            d_feats = sparse_conv_dgrad(g, w_bwd, bwd_idx)
        if ctx.needs_input_grad[1]:
            d_w = sparse_conv_wgrad(feats, g, idx)
        return d_feats, d_w, None, None, None


def sparse_conv_train(feats: torch.Tensor, weight: torch.Tensor, idx: torch.Tensor,
                      bwd_idx: torch.Tensor, mirror: bool) -> torch.Tensor:
    """The differentiable sparse conv (see SparseConvFunction)."""
    return SparseConvFunction.apply(feats, weight, idx, bwd_idx, mirror)
