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

A CUDA tensor launches hand-written kernels, chosen by dtype:
  * bfloat16, the main path's compute type, takes the tensor-core kernels of
    csrc/sparse_conv_tc.cu (mma.sync bf16 -> float32 fed by cp.async row
    gathers);
  * float32 takes the 3xTF32 tensor-core kernels of csrc/sparse_conv_tf32.cu:
    each operand split into two tf32 parts in registers, three tf32 mma per
    product, float32 accuracy (see the source), fed by the same cp.async
    gathers.
Both take rows whose width is a multiple of 4 (their 16-byte cp.async
pieces). A narrower or odd width, CenterPoint's 5 point features (x, y, z,
intensity, sweep lag) into conv_input and out of its dgrad, is zero-padded
inside the wrapper to a multiple of 8 (`_narrow_pad`): feats or g get zero
columns, the weight zero rows (input side, per tap) or zero columns (output
side), and the padded output columns or dW rows are dropped. This is exact,
since zero products add nothing, and it keeps one kernel instance set: an
8-column bf16 row is one 16-byte piece. The padded copy of an [N, 5] input
is one more pass over N rows; its cost shows on the host clock (a few more
launches a call), hardly on the device. A kernel instance for narrow rows
would have needed sub-16-byte gathers in both sources for one conv of 21.
Their launch plans (`gather_gemm_plan`, `tf32_gemm_plan`, `wgrad_plan`) are
plain Python, so the CPU tests check that every launch
of the encoder fits the card's shared memory; the C entry points recompute
the layout and refuse a plan that disagrees. The first design's CUDA-core
kernels (csrc/sparse_conv.cu, float32 FMAs) are on no path:
`sparse_conv_cuda_cores` and `sparse_conv_wgrad_cuda_cores` launch them,
uncounted, as the yardstick a card run times the tensor-core kernels
against. All sources build on first use. A CPU tensor takes the plain
PyTorch versions (`sparse_conv_ref`, `sparse_conv_wgrad_ref`), which the CPU
tests hold against the JAX ops; a CUDA tensor never does. `split_tf32` and
`sparse_conv_3xtf32_ref` are the float32 kernels' arithmetic in plain
PyTorch, for the CPU tests. Each public wrapper counts its launches
(`.launches`) and, of those, the ones that took the float32 kernels
(`.tf32_launches`).

The forward is the operator `rpc::sparse_conv_fwd` (torch.library), so that
torch.export records it as one node with a fake (shape-only) version and an
exported program launches the kernel (cli/export.py); `sparse_conv` and
SparseConvFunction's forward call it and nothing else launches the forward.
The dgrad and the wgrad stay direct calls: no exported path runs them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the CUDA-core kernels (csrc/sparse_conv.cu)
_THREADS = 256
_WGRAD_MAX_PAIRS = 8192  # Cin*Cout: 32 float32 accumulators per thread
_WGRAD_SMEM_FLOATS = 12288  # the staged hits: cap * (Cin + Cout) floats (48 KiB)
_WGRAD_MAX_CAP = 512
_WGRAD_SMS = 132  # an H100's SMs; the grid aims at a few resident blocks on each
# the tensor-core kernels (csrc/sparse_conv_tc.cu; kPad, kStages, kMaxTaps,
# kMaxTileM and kMaxCap there)
_TC_PAD = 8  # bf16 appended to every shared-memory row: 16 bytes
_TC_STAGES = 3
_TC_MAX_TAPS = 32
_TC_MAX_WIDTH = 128
_TC_TILE_M = 64  # output rows a block: 4 warps of 16 rows
_TC_WGRAD_THREADS = 256
# the staged hits, cap * row bytes: for bf16 the fastest of 64, 128 and 192 KiB
# (PERF.md); float32 rows take twice the bytes
_TC_WGRAD_SMEM_BYTES = 131072
_TC_WGRAD_MAX_CAP = 1024
# the 3xTF32 kernels (csrc/sparse_conv_tf32.cu; kMaxStages, kMaxTaps,
# kMaxTileM, kMaxThreads, kWarpN, kWgradThreads and kMaxCap there)
_TF32_MAX_STAGES = 3
_TF32_MAX_TILE_M = 128
_TF32_MAX_THREADS = 256
_TF32_WARP_N = 64  # output columns a forward warp owns
_TF32_TILE_M = 64  # output rows a forward block
# a 3-stage ring where two blocks still fit an SM's 228 KB (each block keeps 1
# KB and the static live-tap word), else 2 stages
_TF32_TWO_BLOCKS_SMEM = 115712
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on an H100 (227 KB)


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


def _pad_width(width: int, least: int = 16) -> int:
    """The width a tensor-core kernel instance is built for: a power of two, >= least."""
    pad = least
    while pad < width:
        pad *= 2
    return pad


def _tc_widths(what: str, cin: int, cout: int, least: int = 16) -> tuple:
    for name, v in (("Cin", cin), ("Cout", cout)):
        if not (0 < v <= _TC_MAX_WIDTH and v % 4 == 0):
            raise ValueError(f"{what}: {name}={v} must be a multiple of 4 in "
                             f"[4, {_TC_MAX_WIDTH}]")
    return _pad_width(cin, least), _pad_width(cout, least)


class GatherGemmPlan(NamedTuple):
    """Launch of the tensor-core gather-GEMM (csrc/sparse_conv_tc.cu)."""
    tile_m: int  # output rows a block; 16 a warp
    threads: int
    cin_pad: int  # the kernel instance's widths (zero-padded in shared memory)
    cout_pad: int
    stages: int  # taps in flight in the ring
    a_pitch: int  # bytes of one shared row of gathered inputs
    w_pitch: int  # bytes of one shared row of weights (and of the output tile)
    smem_bytes: int  # dynamic shared memory: the index tile + max(ring, output tile)


def gather_gemm_plan(cin: int, cout: int, k: int) -> GatherGemmPlan:
    """The launch plan of the bf16 forward/dgrad for [*, Cin] rows, K taps, Cout outputs."""
    cin_pad, cout_pad = _tc_widths("sparse_conv", cin, cout)
    if not 0 < k <= _TC_MAX_TAPS:
        raise ValueError(f"sparse_conv: bf16 K={k} taps must be in [1, {_TC_MAX_TAPS}]")
    tile = _TC_TILE_M
    a_pitch, w_pitch = 2 * (cin_pad + _TC_PAD), 2 * (cout_pad + _TC_PAD)
    stage = tile * a_pitch + cin_pad * w_pitch
    smem = -(-tile * k * 4 // 16) * 16 + max(_TC_STAGES * stage, tile * w_pitch)
    return GatherGemmPlan(tile, 2 * tile, cin_pad, cout_pad, _TC_STAGES, a_pitch, w_pitch, smem)


class WgradPlan(NamedTuple):
    """Launch of a tensor-core wgrad (csrc/sparse_conv_tc.cu, sparse_conv_tf32.cu)."""
    rows_per_chunk: int
    chunks: int  # grid: (chunks, K)
    cap: int  # most hits staged per barrier
    step: int  # index rows scanned per list step
    cin_pad: int
    cout_pad: int
    a_pitch: int  # bytes of one shared row of gathered feats
    g_pitch: int  # bytes of one shared row of g
    smem_bytes: int  # max(staged rows + hit lists, the per-warp sums' merge)


def _wgrad_chunks(m: int, k: int, cin: int, cout: int) -> tuple:
    """(rows per chunk, chunks) of the wgrad grid, either design: the
    (chunk, tap) grid aims at 8 blocks per SM when the [Cin, Cout] partial
    is small (narrow convs: their time goes to scanning the index) and 4
    otherwise (fewer partials to write and sum); rows per chunk are a
    multiple of the 256 rows of the longest scan step."""
    target = _WGRAD_SMS * (8 if cin * cout <= 1024 else 4)
    chunks = min(max(1, -(-target // k)), max(1, -(-m // _THREADS)))
    rows = -(-max(m, 1) // chunks)
    rows = -(-rows // _THREADS) * _THREADS
    return rows, -(-max(m, 1) // rows)


def _wgrad_grid(m: int, k: int, cin: int, cout: int) -> tuple:
    """(rows per chunk, chunks, cap) of the CUDA-core wgrad. cap: the most
    hits staged per barrier, the largest power of two whose gathered float32
    rows fit _WGRAD_SMEM_FLOATS."""
    cap = _WGRAD_MAX_CAP
    while cap > 2 and cap * (cin + cout) > _WGRAD_SMEM_FLOATS:
        cap //= 2
    return (*_wgrad_chunks(m, k, cin, cout), cap)


def wgrad_plan(m: int, k: int, cin: int, cout: int, elem_bytes: int = 2) -> WgradPlan:
    """The launch plan of the bf16 wgrad (elem_bytes 2) or the float32 one (4):
    the CUDA-core design's grid; cap the largest power of two (16 to 1024)
    whose padded rows fit _TC_WGRAD_SMEM_BYTES."""
    cin_pad, cout_pad = _tc_widths("sparse_conv_wgrad", cin, cout)
    if elem_bytes == 2:
        a_pitch, g_pitch = 2 * (cin_pad + _TC_PAD), 2 * (cout_pad + _TC_PAD)
    else:
        a_pitch, g_pitch = 4 * tf32_col_pitch(cin_pad), 4 * tf32_col_pitch(cout_pad)
    cap = _TC_WGRAD_MAX_CAP
    while cap > 16 and cap * (a_pitch + g_pitch) > _TC_WGRAD_SMEM_BYTES:
        cap //= 2
    units = (cin_pad // 16) * (cout_pad // 16)  # 16x16 tiles over 8 warps
    groups = 8 // units if units < 8 else 1
    merge = 4 * groups * cin_pad * cout_pad if groups > 1 else 0
    smem = max(cap * (a_pitch + g_pitch) + 4 * (2 * cap + 8), merge)
    rows, chunks = _wgrad_chunks(m, k, cin, cout)
    return WgradPlan(rows, chunks, cap, min(_TC_WGRAD_THREADS, cap // 2), cin_pad, cout_pad,
                     a_pitch, g_pitch, smem)


def tf32_row_pitch(width: int) -> int:
    """Floats of a shared row whose fragments read 8 rows x 4 consecutive
    columns (the forward's A): 4 mod 8, so a warp's loads hit 32 banks."""
    return width + 4


def tf32_col_pitch(width: int) -> int:
    """Floats of a shared row whose fragments read 4 rows x 8 consecutive
    columns (the forward's W, both wgrad operands): 8 or 24 mod 32."""
    return width + 8 if (width + 8) % 32 in (8, 24) else width + 16


class Tf32GemmPlan(NamedTuple):
    """Launch of the 3xTF32 gather-GEMM (csrc/sparse_conv_tf32.cu)."""
    tile_m: int  # output rows a block; 16 a warp
    threads: int  # 32 per 16 rows and _TF32_WARP_N columns
    cin_pad: int  # the kernel instance's widths (zero-padded in shared memory)
    cout_pad: int
    stages: int  # taps in flight in the ring
    a_pitch: int  # bytes of one shared row of gathered inputs
    w_pitch: int  # bytes of one shared row of weights
    smem_bytes: int  # dynamic shared memory: the index tile + the ring


def tf32_gemm_plan(cin: int, cout: int, k: int) -> Tf32GemmPlan:
    """The launch plan of the float32 forward/dgrad for [*, Cin] rows, K taps,
    Cout outputs: 3 ring stages where two blocks still fit an SM, else 2."""
    cin_pad, cout_pad = _tc_widths("sparse_conv", cin, cout, least=8)
    if not 0 < k <= _TC_MAX_TAPS:
        raise ValueError(f"sparse_conv: float32 K={k} taps must be in [1, {_TC_MAX_TAPS}]")
    tile = _TF32_TILE_M
    threads = tile // 16 * max(1, cout_pad // _TF32_WARP_N) * 32
    if tile % 16 or not 16 <= tile <= _TF32_MAX_TILE_M or threads > _TF32_MAX_THREADS:
        raise ValueError(f"sparse_conv: float32 tile of {tile} rows at Cout={cout} needs "
                         f"{threads} threads")
    a_pitch, w_pitch = 4 * tf32_row_pitch(cin_pad), 4 * tf32_col_pitch(cout_pad)
    stage = tile * a_pitch + cin_pad * w_pitch
    idx_bytes = -(-tile * k * 4 // 16) * 16
    stages = _TF32_MAX_STAGES
    if idx_bytes + stages * stage > _TF32_TWO_BLOCKS_SMEM:
        stages = 2
    return Tf32GemmPlan(tile, threads, cin_pad, cout_pad, stages, a_pitch, w_pitch,
                        idx_bytes + stages * stage)


def split_tf32(x: torch.Tensor) -> tuple:
    """float32 x -> (big, small), both tf32 values, as the kernels split an
    operand: big = x rounded to 10 fraction bits, to nearest with ties away
    from zero (cvt.rna.tf32.f32, low 13 bits cleared), small = the same
    rounding of x - big (exact in float32). NaN keeps itself as big."""
    bits = x.contiguous().view(torch.int32)

    def rna(b):
        mag = (b & 0x7FFFFFFF) + 0x1000  # half of the 13 dropped bits: ties away
        return ((mag & 0x7FFFE000) | (b & -0x80000000)).view(torch.float32)

    big = torch.where(torch.isnan(x), x, rna(bits))
    small = rna((x - big).contiguous().view(torch.int32))
    return big, small


def sparse_conv_3xtf32_ref(feats: torch.Tensor, kernel: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """The float32 kernels' arithmetic in plain PyTorch: the img2col gather,
    then big*big + big*small + small*big of the split operands, products
    exact and sums in float32."""
    n, c = feats.shape
    feats_pad = torch.cat([feats, feats.new_zeros(1, c)], 0)
    col = feats_pad[idx.long()].reshape(idx.shape[0], idx.shape[1] * c)
    (a_big, a_small), (w_big, w_small) = split_tf32(col), split_tf32(kernel)
    return a_small @ w_big + a_big @ w_small + a_big @ w_big


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


def _tc_lib() -> ctypes.CDLL:
    lib = load_library("sparse_conv_tc")
    fwd = lib.rpc_sparse_conv_tc_fwd
    if fwd.argtypes is None:
        i, i64, p = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        fwd.argtypes = [p, p, p, p, i64, i64, i, i, i, i, i, i, i, p]
        fwd.restype = i
        wg = lib.rpc_sparse_conv_tc_wgrad
        wg.argtypes = [p, p, p, p, p, i64, i64, i, i, i, i, i, i64, i, i, i, i, p]
        wg.restype = i
    return lib


def _tf32_lib() -> ctypes.CDLL:
    lib = load_library("sparse_conv_tf32")
    fwd = lib.rpc_sparse_conv_tf32_fwd
    if fwd.argtypes is None:
        i, i64, p = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
        fwd.argtypes = [p, p, p, p, i64, i64, i, i, i, i, i, i, i, i, i, p]
        fwd.restype = i
        wg = lib.rpc_sparse_conv_tf32_wgrad
        wg.argtypes = [p, p, p, p, p, i64, i64, i, i, i, i, i, i64, i, i, i, i, p]
        wg.restype = i
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


def _check_aligned(name, *tensors):
    """The tensor-core kernels copy 16-byte pieces: every base must be 16-byte aligned."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the tensor-core kernels need 16-byte aligned inputs")


def _rc(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def _gather_gemm_shapes(name, feats, kernel, idx):
    _check(name, feats, kernel, idx)
    m, k = idx.shape
    cin, cout = feats.shape[1], kernel.shape[1]
    if kernel.shape[0] != k * cin:
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} does not match "
                         f"K={k} taps of Cin={cin}")
    return m, k, cin, cout


def sparse_conv_cuda_cores(feats: torch.Tensor, kernel: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """The first design's CUDA-core gather-GEMM (csrc/sparse_conv.cu) on
    float32 or bf16 CUDA tensors, on no path: a yardstick; counts nothing."""
    name = "sparse_conv_cuda_cores"
    m, k, cin, cout = _gather_gemm_shapes(name, feats, kernel, idx)
    if cout > _THREADS or _THREADS % cout != 0:
        raise ValueError(f"{name}: Cout={cout} must divide {_THREADS}")
    out = torch.empty((m, cout), dtype=feats.dtype, device=feats.device)
    _rc(name, _lib().rpc_sparse_conv_fwd(
        feats.data_ptr(), kernel.data_ptr(), idx.data_ptr(), out.data_ptr(),
        feats.shape[0], m, k, cin, cout,
        _DTYPE_CODES[feats.dtype], torch.cuda.current_stream(feats.device).cuda_stream))
    return out


def _gather_gemm_tc(name, feats, kernel, idx):
    m, k, cin, cout = _gather_gemm_shapes(name, feats, kernel, idx)
    plan = gather_gemm_plan(cin, cout, k)
    _check_aligned(name, feats, kernel, idx)
    out = torch.empty((m, cout), dtype=feats.dtype, device=feats.device)
    _rc(name, _tc_lib().rpc_sparse_conv_tc_fwd(
        feats.data_ptr(), kernel.data_ptr(), idx.data_ptr(), out.data_ptr(),
        feats.shape[0], m, k, cin, cout, plan.cin_pad, plan.cout_pad, plan.tile_m,
        plan.smem_bytes, torch.cuda.current_stream(feats.device).cuda_stream))
    return out


def _gather_gemm_tf32(name, feats, kernel, idx):
    m, k, cin, cout = _gather_gemm_shapes(name, feats, kernel, idx)
    plan = tf32_gemm_plan(cin, cout, k)
    _check_aligned(name, feats, kernel, idx)
    out = torch.empty((m, cout), dtype=feats.dtype, device=feats.device)
    _rc(name, _tf32_lib().rpc_sparse_conv_tf32_fwd(
        feats.data_ptr(), kernel.data_ptr(), idx.data_ptr(), out.data_ptr(),
        feats.shape[0], m, k, cin, cout, plan.cin_pad, plan.cout_pad, plan.tile_m,
        plan.threads, plan.stages, plan.smem_bytes,
        torch.cuda.current_stream(feats.device).cuda_stream))
    return out


def _narrow_pad(width: int) -> int:
    """The width a row is zero-padded to before a tensor-core launch: itself
    when a multiple of 4, else the next multiple of 8 (5 -> 8)."""
    return width if width % 4 == 0 else -(-width // 8) * 8


def _pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    return x if x.shape[-1] == width else F.pad(x, (0, width - x.shape[-1]))


def _gather_gemm(wrapper, name, feats, kernel, idx):
    """bf16 -> the bf16 tensor-core kernel, float32 -> the 3xTF32 one; counted.
    Rows of a width the kernels do not take are zero-padded around the launch."""
    _, k, cin, cout = _gather_gemm_shapes(name, feats, kernel, idx)
    cin_p, cout_p = _narrow_pad(cin), _narrow_pad(cout)
    if (cin_p, cout_p) != (cin, cout):
        feats = _pad_cols(feats, cin_p)
        kernel = _pad_cols(kernel.reshape(k, cin, cout).transpose(1, 2), cin_p)
        kernel = _pad_cols(kernel.transpose(1, 2).reshape(k * cin_p, cout), cout_p)
        out = _gather_gemm(wrapper, name, feats, kernel.contiguous(), idx)
        return out[:, :cout].contiguous()
    if feats.dtype == torch.bfloat16:
        out = _gather_gemm_tc(name, feats, kernel, idx)
    else:
        out = _gather_gemm_tf32(name, feats, kernel, idx)
        wrapper.tf32_launches += 1
    wrapper.launches += 1
    return out


# The operator is registered through torch.library's low-level API and not
# torch.library.custom_op, which runs every call through two layers of
# Python (an autograd kernel and a backend wrapper with an aliasing check)
# before the launch; here the dispatcher calls the implementation directly.
# The forward runs only with gradients off (SparseConvFunction.forward, or
# a call that needs none), so the operator needs no autograd kernel.
torch.library.define("rpc::sparse_conv_fwd",
                     "(Tensor feats, Tensor kernel, Tensor idx) -> Tensor")


def _sparse_conv_fwd_cpu(feats, kernel, idx):
    return sparse_conv_ref(feats, kernel, idx)  # looked up per call: a wrapper of it counts


def _sparse_conv_fwd_cuda(feats, kernel, idx):
    # checks, alignment, the stream and the count live here: a traced call
    # reaches only the fake below, so it launches and counts nothing
    return _gather_gemm(sparse_conv, "sparse_conv", feats, kernel, idx)


def _sparse_conv_fwd_fake(feats, kernel, idx):
    return feats.new_empty((idx.shape[0], kernel.shape[1]))


# (torch.library.impl used as a decorator returns None: registered by call)
torch.library.impl("rpc::sparse_conv_fwd", "cpu", _sparse_conv_fwd_cpu)
torch.library.impl("rpc::sparse_conv_fwd", "cuda", _sparse_conv_fwd_cuda)
torch.library.register_fake("rpc::sparse_conv_fwd", _sparse_conv_fwd_fake)


# The forward gather-GEMM as an operator that torch.export records as one
# node: the plain version on the CPU, the tensor-core kernels on the card,
# an empty [M, Cout] while tracing.
sparse_conv_fwd = torch.ops.rpc.sparse_conv_fwd.default


def sparse_conv(feats: torch.Tensor, kernel: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats [N, Cin], kernel [K*Cin, Cout], idx [M, K] int32 -> [M, Cout]
    in feats' dtype, through the operator rpc::sparse_conv_fwd."""
    if feats.device.type not in ("cpu", "cuda"):  # a meta tensor would get the fake's empty rows
        raise ValueError(f"sparse_conv: inputs on {feats.device}: neither the plain version "
                         "nor the kernel takes them")
    return sparse_conv_fwd(feats, kernel, idx)


def sparse_conv_dgrad(g: torch.Tensor, kernel_bwd: torch.Tensor, bwd_idx: torch.Tensor) -> torch.Tensor:
    """d_feats [N, Cin] from g [M, Cout], kernel_bwd [K*Cout, Cin] (see
    `backward_kernel`) and the backward index [N, K] in [0, M] (M = miss).

    The forward's gather-GEMM kernel, launched and counted on its own."""
    if g.device.type == "cpu":
        return sparse_conv_ref(g, kernel_bwd, bwd_idx)
    return _gather_gemm(sparse_conv_dgrad, "sparse_conv_dgrad", g, kernel_bwd, bwd_idx)


def _wgrad_shapes(feats, g, idx):
    _check("sparse_conv_wgrad", feats, g, idx)
    m, k = idx.shape
    if g.shape[0] != m:
        raise ValueError(f"sparse_conv_wgrad: g has {g.shape[0]} rows, idx {m}")
    return m, k, feats.shape[1], g.shape[1]


def sparse_conv_wgrad_cuda_cores(feats: torch.Tensor, g: torch.Tensor,
                                 idx: torch.Tensor) -> torch.Tensor:
    """The first design's CUDA-core wgrad (csrc/sparse_conv.cu) on float32 or
    bf16 CUDA tensors, on no path: a yardstick; counts nothing."""
    m, k, cin, cout = _wgrad_shapes(feats, g, idx)
    pairs = cin * cout
    if cout > _THREADS or _THREADS % cout != 0:
        raise ValueError(f"sparse_conv_wgrad: Cout={cout} must divide {_THREADS}")
    if pairs > _WGRAD_MAX_PAIRS or pairs & (pairs - 1):
        raise ValueError(f"sparse_conv_wgrad: Cin*Cout={pairs} must be a power of two "
                         f"and at most {_WGRAD_MAX_PAIRS}")
    rows, chunks, cap = _wgrad_grid(m, k, cin, cout)
    partial = torch.empty((chunks, k * pairs), dtype=torch.float32, device=feats.device)
    dw = torch.empty((k * cin, cout), dtype=torch.float32, device=feats.device)
    _rc("sparse_conv_wgrad", _lib().rpc_sparse_conv_wgrad(
        feats.data_ptr(), g.data_ptr(), idx.data_ptr(), partial.data_ptr(), dw.data_ptr(),
        feats.shape[0], m, k, cin, cout, rows, chunks, cap,
        _DTYPE_CODES[feats.dtype], torch.cuda.current_stream(feats.device).cuda_stream))
    return dw


def _wgrad_tc(feats, g, idx):
    """The bf16 wgrad (csrc/sparse_conv_tc.cu) or the 3xTF32 one (csrc/
    sparse_conv_tf32.cu): one plan layout, one argument list."""
    m, k, cin, cout = _wgrad_shapes(feats, g, idx)
    plan = wgrad_plan(m, k, cin, cout, feats.element_size())
    _check_aligned("sparse_conv_wgrad", feats, g, idx)
    entry = (_tc_lib().rpc_sparse_conv_tc_wgrad if feats.dtype == torch.bfloat16
             else _tf32_lib().rpc_sparse_conv_tf32_wgrad)
    partial = torch.empty((plan.chunks, k * cin * cout), dtype=torch.float32, device=feats.device)
    dw = torch.empty((k * cin, cout), dtype=torch.float32, device=feats.device)
    _rc("sparse_conv_wgrad", entry(
        feats.data_ptr(), g.data_ptr(), idx.data_ptr(), partial.data_ptr(), dw.data_ptr(),
        feats.shape[0], m, k, cin, cout, plan.cin_pad, plan.cout_pad, plan.rows_per_chunk,
        plan.chunks, plan.cap, plan.step, plan.smem_bytes,
        torch.cuda.current_stream(feats.device).cuda_stream))
    return dw


def _wgrad(feats, g, idx):
    """_wgrad_tc with rows of a width it does not take zero-padded around the
    launch and the pad rows of dW dropped."""
    _, k, cin, cout = _wgrad_shapes(feats, g, idx)
    cin_p, cout_p = _narrow_pad(cin), _narrow_pad(cout)
    dw = _wgrad_tc(_pad_cols(feats, cin_p), _pad_cols(g, cout_p), idx)
    if (cin_p, cout_p) != (cin, cout):
        dw = dw.reshape(k, cin_p, cout_p)[:, :cin, :cout].reshape(k * cin, cout)
    return dw


def sparse_conv_wgrad(feats: torch.Tensor, g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """d_W [K*Cin, Cout] float32 from feats [N, Cin], g [M, Cout] and the
    forward index [M, K]."""
    if feats.device.type == "cpu":
        return sparse_conv_wgrad_ref(feats, g, idx)
    dw = _wgrad(feats, g, idx)
    if feats.dtype == torch.float32:
        sparse_conv_wgrad.tf32_launches += 1
    sparse_conv_wgrad.launches += 1
    return dw


for _fn in (sparse_conv, sparse_conv_dgrad, sparse_conv_wgrad):
    _fn.launches = 0
    _fn.tf32_launches = 0


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
