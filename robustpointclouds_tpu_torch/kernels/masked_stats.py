"""Masked per-channel statistics, their VJP, and the fused MaskedBatchNorm: the port of the Pallas `masked_stats`.

`masked_stats(x [N, C], mask [N]) -> (mean [C], var [C], count)`, all
float32: mean and biased variance over the rows where mask is True, and the
count of those rows (mean and var are 0 when no row is valid). The port runs
it under the perturber's std normalisation and its regulariser statistics
(nn/perturber.py). It is differentiable in x through the Pallas kernel's
analytic VJP (robustpointclouds_tpu/kernels/masked_stats.py:102 `_stats_bwd`):
    dx = m * (g_mean + 2 * g_var * (x - mean)) / max(cnt, 1)
with no gradient to the mask or the count.

`masked_batch_norm(...)` is MaskedBatchNorm (nn/layers.py) with the
statistics, the normalisation, the affine map, ReLU and the row mask of
SparseConvBlock in two kernels (train mode: statistics, then apply; eval:
apply alone), and its backward in two more (`bwd_reduce` for the per-channel
sums, `dx`), through `MaskedBatchNormFunction`. With r = rsqrt(var + eps),
xhat = (x - mean) r, y = xhat gamma + beta and g_eff the output cotangent
gated by ReLU (y > 0) and by the row mask:
    d beta = sum g_eff,  d gamma = sum g_eff xhat   (over all rows)
    dx = gamma r (g_eff - m (d beta + xhat d gamma) / max(cnt, 1))   (train)
    dx = gamma r g_eff                                              (eval)
the second line being the masked-stats VJP applied to the statistics'
cotangents. In eval mode with frozen parameters (PGD) the sums are not
computed at all.

A CUDA tensor launches the kernels of csrc/masked_stats.cu (built on first
use); a CPU tensor takes the plain versions: `masked_stats_ref` (the two-pass
form of robustpointclouds_tpu/nn/layers.masked_mean), `masked_stats_bwd_ref`,
`masked_batch_norm_ref` (the eager composition MaskedBatchNorm ran before:
statistics, running-stat update, normalise, affine, cast, ReLU, row mask) and
`masked_batch_norm_bwd_ref` (the analytic backward above in torch). Nothing
falls back: what the kernels do not take raises, apart from the statistics
and their VJP at a width between two of WIDTHS (CenterPoint's 5 point
features): the wrapper zero-pads the columns to the next width (5 -> 8)
and drops the pad columns of the result. The statistics are per channel,
so the padding is exact. Each wrapper counts its
launches (`.launches`); `masked_batch_norm_bwd.reduce_launches` counts the
backward calls that ran `bwd_reduce`; `KERNEL_LAUNCHES` counts every launch
of the five kernels by (kernel, C), C the width the kernel ran at, and
`KERNEL_ROW_LAUNCHES` by (kernel, C, N), N its rows. The launch plan (`row_plan`) is plain
Python, checked on the CPU.

The bfloat16-read mode (`lowp=True`, the JAX package's RPC_BN_BF16_STATS,
robustpointclouds_tpu/nn/layers.py:68-94; bfloat16 x only) rounds as JAX's
lowp path does: mean = sum(x) / max(cnt, 1) summed in float32; d = bf16(x -
bf16(mean)); var = sum(bf16(d * d)) / max(cnt, 1); then a = bf16(r gamma),
b = bf16(beta - mean r gamma) and y = bf16(bf16(x a) + b). On the card the
statistics are two launches of the statistics kernel (the variance is
centred on the rounded mean, so it needs its own pass over x) and the
apply kernel takes the mode as a flag; the plain versions are
`masked_stats_lowp_ref` and `bn_apply_ref(..., lowp=True)`. The backward is
the analytic one above on the lowp statistics (tests/test_torch_bn_bf16_stats.py
holds it to JAX's autodiff of the lowp path at a bfloat16 tolerance), with
one change: its ReLU gate reads the y the lowp forward rounded, not the
float32 y, as JAX's autodiff gates on the y it computed (on the float32 y a
gate at a y within bfloat16 rounding of 0 flips, and moved single dx
entries by up to 63% of dx's largest, measured on the CPU at C = 64).

The apply kernel is the operator `rpc::masked_bn_apply` (torch.library),
whose CPU version is `bn_apply_ref`: torch.export records it as one node
and an exported program launches it (cli/export.py). `_bn_forward` reaches
it in train and eval mode, and nothing else launches it; the apply's
launch counts tick inside its CUDA version. The statistics kernel (which
updates the running statistics in place in training), the VJP,
`bwd_reduce` and `dx` stay direct calls: no exported path runs them (an
eval-mode BN reads the running statistics).
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
WIDTHS = (4, 8, 16, 32, 64, 128, 256)  # C: powers of two up to csrc kMaxC
_THREADS = 256  # csrc kThreads
_SMS = 132  # an H100's SMs
_BLOCKS_PER_SM = 2  # csrc kMinBlocks: every grid is one wave of resident blocks
_REDUCE_ROWS = 8  # rows a reduction's thread takes at least (csrc kStatsUnroll)
_VEC4_MAX_C = 128  # float32 rows up to this width load one float4 a thread (csrc kVec4MaxC)
KERNEL_LAUNCHES: Counter = Counter()  # (kernel name in csrc, C) -> launches
KERNEL_ROW_LAUNCHES: Counter = Counter()  # (kernel name in csrc, C, N) -> launches


def _count(kernel: str, c: int, n: int, launches: int = 1) -> None:
    KERNEL_LAUNCHES[kernel, c] += launches
    KERNEL_ROW_LAUNCHES[kernel, c, n] += launches


class RowPlan(NamedTuple):
    """Launch of one kernel of csrc/masked_stats.cu over [N, C] rows."""
    vec: int  # channels a thread loads at once: 16 bytes (8 for 4-channel bf16
    # rows; two 16-byte loads for 256-channel float32 rows, so a row fits a warp)
    lanes: int  # threads a row: C / vec, at most 32
    rows_per_block: int  # rows a block visits per grid step
    blocks: int
    workspace_floats: int  # partials of a reduction: blocks * (2C + 1)


def row_plan(n: int, c: int, dtype: torch.dtype, reduce: bool) -> RowPlan:
    """The grid of a reduction (`reduce`: statistics, bwd_reduce) or a
    streaming kernel (apply, dx, VJP) over n rows of c channels: one wave of
    resident blocks. A reduction's last block merges one partial a block on
    one SM, so a small input gets only as many blocks as give each thread a
    batch of _REDUCE_ROWS rows."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"masked statistics: x must be float32 or bfloat16, got {dtype}")
    if c not in WIDTHS:
        raise ValueError(f"masked statistics: C={c} must be one of {WIDTHS}")
    if n < 1:
        raise ValueError("masked statistics: x has no rows")
    vec = 4 if (dtype == torch.float32 and c <= _VEC4_MAX_C) or c == 4 else 8
    lanes = c // vec
    rows = _THREADS // lanes
    if reduce:  # a full batch of rows a thread: fewer partials on small inputs
        rows *= _REDUCE_ROWS
    blocks = max(1, min(-(-n // rows), _SMS * _BLOCKS_PER_SM))
    return RowPlan(vec, lanes, _THREADS // lanes, blocks,
                   blocks * (2 * c + 1) if reduce else 0)


def masked_stats_ref(x: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: masked mean, then the masked mean of squared deviations."""
    xf = x.float()
    m = mask.to(torch.float32)[:, None]
    cnt = m.sum()
    safe = torch.clamp(cnt, min=1.0)
    mean = (xf * m).sum(0) / safe
    var = (((xf - mean) ** 2) * m).sum(0) / safe
    return mean, var, cnt


def masked_stats_bwd_ref(x: torch.Tensor, mask: torch.Tensor, mean: torch.Tensor,
                         cnt: torch.Tensor, g_mean: Optional[torch.Tensor],
                         g_var: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the VJP; dx in x's dtype."""
    d = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    if g_mean is not None:
        d = d + g_mean.float()[None, :]
    if g_var is not None:
        d = d + 2.0 * g_var.float()[None, :] * (x.float() - mean[None, :])
    m = mask.to(torch.float32)[:, None]
    return (m * d / torch.clamp(cnt, min=1.0)).to(x.dtype)


def masked_stats_lowp_ref(x: torch.Tensor, mask: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the bfloat16-read statistics (bfloat16 x):
    the float32 sum of x over the valid rows / max(cnt, 1), then the
    float32 sum of bf16(d * d), d = bf16(x - bf16(mean)), / max(cnt, 1)."""
    m = mask[:, None].to(x.dtype)
    cnt = mask.to(torch.float32).sum()
    safe = torch.clamp(cnt, min=1.0)
    mean = (x * m).sum(0, dtype=torch.float32) / safe
    d = x - mean.to(x.dtype)
    var = (d * d * m).sum(0, dtype=torch.float32) / safe
    return mean, var, cnt


def _check_lowp(name: str, x: torch.Tensor, lowp: bool) -> None:
    if lowp and x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the bfloat16-read mode takes bfloat16 x, got {x.dtype}")


def _bn_stats_ref(x, mask, running_mean, running_var, training, momentum, lowp=False):
    """(mean, var, count or None) a BN normalises with: the batch's, with the
    running statistics updated in place, in training; the running ones in eval."""
    if not training:
        return running_mean, running_var, None
    mu, var, cnt = masked_stats_lowp_ref(x, mask) if lowp else masked_stats_ref(x, mask)
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(momentum * mu)
        running_var.mul_(1.0 - momentum).add_(momentum * var)
    return mu, var, cnt


def bn_apply_ref(x: torch.Tensor, mask: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor, eps: float, relu: bool,
                 row_mask: bool, out_dtype: torch.dtype, lowp: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the apply kernel: normalise with the given
    statistics, affine, cast, ReLU, row mask (differentiable by autograd).
    `lowp`: the bfloat16-read mode's y = x * a + b in x's type, a and b the
    per-channel scale and shift rounded to it."""
    if lowp:
        r = torch.rsqrt(var + eps)
        a = (r * weight).to(x.dtype)
        b = (bias - mean * r * weight).to(x.dtype)
        y = (x * a + b).to(out_dtype)
    else:
        y = (x.float() - mean) * torch.rsqrt(var + eps)
        y = (y * weight + bias).to(out_dtype)
    if relu:
        y = torch.relu(y)
    if row_mask:
        y = torch.where(mask[:, None], y, torch.zeros_like(y))
    return y


def _bn_ref(x, mask, weight, bias, running_mean, running_var, training, momentum, eps, relu,
            row_mask, out_dtype, lowp=False):
    """masked_batch_norm_ref and the statistics it normalised with."""
    mu, var, cnt = _bn_stats_ref(x, mask, running_mean, running_var, training, momentum, lowp)
    return (bn_apply_ref(x, mask, mu, var, weight, bias, eps, relu, row_mask, out_dtype, lowp),
            mu, var, cnt)


def masked_batch_norm_ref(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, running_mean: torch.Tensor,
                          running_var: torch.Tensor, training: bool, momentum: float = 0.1,
                          eps: float = 1e-3, relu: bool = False, row_mask: bool = False,
                          out_dtype: Optional[torch.dtype] = None,
                          lowp: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the fused forward (differentiable by autograd);
    updates the running statistics in place in training."""
    _check_lowp("masked_batch_norm", x, lowp)
    return _bn_ref(x, mask, weight, bias, running_mean, running_var, training, momentum, eps,
                   relu, row_mask, out_dtype or x.dtype, lowp)[0]


def masked_batch_norm_bwd_ref(g: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                              weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
                              var: torch.Tensor, cnt: Optional[torch.Tensor], eps: float,
                              training: bool, relu: bool = False, row_mask: bool = False,
                              lowp: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the analytic backward: (dx in x's dtype,
    d gamma, d beta); mean/var are the statistics the forward normalised with.
    `lowp`: the ReLU gate reads the bfloat16-read mode's y."""
    r = torch.rsqrt(var + eps)
    xh = (x.float() - mean) * r
    ge = g.float()
    if relu:  # a NaN y passes, as torch.relu's backward lets it
        y = (bn_apply_ref(x, mask, mean, var, weight, bias, eps, False, False, x.dtype, True)
             if lowp else xh * weight + bias)
        ge = ge.masked_fill(y <= 0, 0.0)
    if row_mask:
        ge = torch.where(mask[:, None], ge, torch.zeros_like(ge))
    s1 = ge.sum(0)
    s2 = (ge * xh).sum(0)
    t = ge
    if training:
        n = torch.clamp(cnt, min=1.0)
        t = ge - mask.to(torch.float32)[:, None] * (s1 / n + xh * (s2 / n))
    return ((weight * r) * t).to(x.dtype), s2, s1


# ---- the card's kernels

_FNS: Dict[str, object] = {}
_WORKSPACES: Dict[tuple, list] = {}


def bind(lib: ctypes.CDLL) -> Dict[str, object]:
    """The five entry points of a build of csrc/masked_stats.cu, typed."""
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    args = {  # pointers and the stream must not pass as 32-bit ints
        "rpc_masked_stats": [p, p, p, p, p, p, p, f, f, i64, i, i, i, i, i, p],
        "rpc_masked_bn_apply": [p, p, p, p, p, p, p, i64, i, f, i, i, i, i, i, i, i, p],
        "rpc_masked_bn_bwd_reduce": [p, p, p, p, p, p, p, p, p, p, i64, i, f, i, i, i, i, i,
                                     i, i, p],
        "rpc_masked_bn_dx": [p, p, p, p, p, p, p, p, p, p, i64, i, f, i, i, i, i, i, i, i, i, p],
        "rpc_masked_stats_vjp": [p, p, p, p, p, p, p, i64, i, i, i, i, p],
    }
    fns = {}
    for key, types in args.items():
        fn = getattr(lib, key)
        fn.argtypes = types
        fn.restype = i
        fns[key] = fn
    return fns


def _fn(name: str):
    if not _FNS:
        _FNS.update(bind(load_library("masked_stats")))
    return _FNS[name]


def _rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def _stream(dev: torch.device) -> int:
    """The current stream of a CUDA device, as the raw handle the kernels take
    (the call torch's own generated kernels use, without a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _workspace(dev: torch.device, stream: int, floats: int):
    """(partials, ticket) of the reductions on `stream`, grown to `floats`;
    the ticket is zeroed once and every reduction leaves it at 0."""
    key = (dev.index, stream)
    entry = _WORKSPACES.get(key)
    if entry is None:
        entry = _WORKSPACES[key] = [torch.empty(0, dtype=torch.float32, device=dev),
                                    torch.zeros(1, dtype=torch.int32, device=dev)]
    if entry[0].numel() < floats:
        entry[0] = torch.empty(floats, dtype=torch.float32, device=dev)
    return entry[0].data_ptr(), entry[1].data_ptr()


def _check_rows(name: str, x: torch.Tensor, mask: torch.Tensor, *others) -> None:
    """x and mask (and any [N, C] `others`) on one CUDA device, contiguous,
    of a supported width and type, with bases aligned to the kernels' vectors
    (16 bytes; 8 for 4-channel bfloat16 rows)."""
    if not (x.is_cuda and mask.device == x.device):
        raise ValueError(f"{name}: x and mask must lie on one CUDA device")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [N, C], got {tuple(x.shape)}")
    c = x.shape[1]
    if c not in WIDTHS:
        raise ValueError(f"{name}: C={c} must be one of {WIDTHS}")
    if mask.dtype != torch.bool or mask.shape != x.shape[:1] or not mask.is_contiguous():
        raise ValueError(f"{name}: mask must be a contiguous bool [N]")
    for t in (x, *others):
        if t.device != x.device or t.shape != x.shape or not t.is_contiguous():
            raise ValueError(f"{name}: every [N, C] input must match x and be contiguous")
        if t.dtype not in _DTYPE_CODES or t.data_ptr() % min(16, c * t.element_size()):
            raise ValueError(f"{name}: [N, C] inputs must be float32/bfloat16 with "
                             f"vector-aligned bases")


def _check_channels(name: str, c: int, dev: torch.device, *vectors) -> None:
    for v in vectors:
        if v is not None and (v.device != dev or v.dtype != torch.float32 or v.shape != (c,)
                              or not v.is_contiguous()):
            raise ValueError(f"{name}: per-channel tensors must be contiguous float32 [{c}] "
                             f"on {dev}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_stats(name: str, x: torch.Tensor, mask: torch.Tensor, stream: int,
                  running_mean: Optional[torch.Tensor] = None,
                  running_var: Optional[torch.Tensor] = None, momentum: float = 0.1,
                  lowp: bool = False):
    """The statistics kernel on checked inputs: (mean, var, count), views of
    one [2C + 1] buffer. One launch; the bfloat16-read mode (`lowp`) two,
    its passes 1 and 2."""
    n, c = x.shape
    plan = row_plan(n, c, x.dtype, reduce=True)
    out = torch.empty(2 * c + 1, dtype=torch.float32, device=x.device)
    ws, ticket = _workspace(x.device, stream, plan.workspace_floats)
    for pass_ in ((1, 2) if lowp else (0,)):
        _rc(name, _fn("rpc_masked_stats")(
            x.data_ptr(), mask.data_ptr(), out.data_ptr(), ws, ticket, _ptr(running_mean),
            _ptr(running_var), momentum, 1.0 - momentum, n, c, _DTYPE_CODES[x.dtype], plan.vec,
            plan.blocks, pass_, stream))
    _count("stats_kernel_lowp" if lowp else "stats_kernel", c, n, 2 if lowp else 1)
    return out[:c], out[c:2 * c], out[2 * c]


def _stats_width(c: int) -> int:
    """The kernel width the statistics and their VJP run [N, c] at: the
    smallest of WIDTHS that holds c (c itself when it is one)."""
    for w in WIDTHS:
        if c <= w:
            return w
    raise ValueError(f"masked statistics: C={c} exceeds {WIDTHS[-1]}")


def _pad_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def _stats(x: torch.Tensor, mask: torch.Tensor):
    if x.device.type == "cpu":
        return masked_stats_ref(x, mask)
    out = _stats_padded(x, mask)
    masked_stats.launches += 1
    return out


def _stats_padded(x: torch.Tensor, mask: torch.Tensor):
    """One statistics launch on x zero-padded to its kernel width; the pad
    channels' results dropped."""
    if x.dim() != 2:
        raise ValueError(f"masked_stats: x must be [N, C], got {tuple(x.shape)}")
    c = x.shape[1]
    xp = _pad_cols(x, _stats_width(c))
    _check_rows("masked_stats", xp, mask)
    mean, var, cnt = _launch_stats("masked_stats", xp, mask, _stream(x.device))
    return mean[:c], var[:c], cnt


def masked_stats_bwd(x: torch.Tensor, mask: torch.Tensor, mean: torch.Tensor, cnt: torch.Tensor,
                     g_mean: Optional[torch.Tensor], g_var: Optional[torch.Tensor]) -> torch.Tensor:
    """dx [N, C] in x's dtype; a missing g_mean or g_var counts as zero."""
    if x.device.type == "cpu":
        return masked_stats_bwd_ref(x, mask, mean, cnt, g_mean, g_var)
    dx = _stats_bwd_padded(x, mask, mean, cnt, g_mean, g_var)
    masked_stats_bwd.launches += 1
    return dx


def _stats_bwd_padded(x, mask, mean, cnt, g_mean, g_var) -> torch.Tensor:
    """One VJP launch on x (and the per-channel vectors) zero-padded to the
    kernel width; the pad columns of dx dropped."""
    if x.dim() != 2:
        raise ValueError(f"masked_stats_bwd: x must be [N, C], got {tuple(x.shape)}")
    c = x.shape[1]
    w = _stats_width(c)
    x = _pad_cols(x, w)
    _check_rows("masked_stats_bwd", x, mask)
    mean, g_mean, g_var = (None if v is None else _pad_cols(v.float(), w).contiguous()
                           for v in (mean, g_mean, g_var))
    _check_channels("masked_stats_bwd", w, x.device, mean, g_mean, g_var)
    dx = _launch_stats_vjp(x, mask, mean, cnt, g_mean, g_var)
    return dx if w == c else dx[:, :c].contiguous()


def _launch_stats_vjp(x, mask, mean, cnt, g_mean, g_var) -> torch.Tensor:
    """One launch of the statistics' VJP kernel on checked inputs."""
    n, c = x.shape
    plan = row_plan(n, c, x.dtype, reduce=False)
    dx = torch.empty_like(x)
    _rc("masked_stats_bwd", _fn("rpc_masked_stats_vjp")(
        x.data_ptr(), mask.data_ptr(), mean.data_ptr(), cnt.data_ptr(), _ptr(g_mean),
        _ptr(g_var), dx.data_ptr(), n, c, _DTYPE_CODES[x.dtype], plan.vec, plan.blocks,
        _stream(x.device)))
    _count("vjp_kernel", c, n)
    return dx


class MaskedStatsFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask):
        mean, var, cnt = _stats(x, mask)
        ctx.save_for_backward(x, mask, mean, cnt)
        ctx.mark_non_differentiable(cnt)
        ctx.set_materialize_grads(False)
        return mean, var, cnt

    @staticmethod
    def backward(ctx, g_mean, g_var, _g_cnt):
        if not ctx.needs_input_grad[0] or (g_mean is None and g_var is None):
            return None, None
        x, mask, mean, cnt = ctx.saved_tensors
        return masked_stats_bwd(x, mask, mean, cnt, g_mean, g_var), None


def masked_stats(x: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean [C], var [C], count) of x's valid rows, float32; differentiable in x.

    Only an input that needs a gradient goes through the autograd Function;
    serving and the perturber's no-grad statistics launch the kernel directly."""
    if x.requires_grad and torch.is_grad_enabled():
        return MaskedStatsFunction.apply(x, mask)
    return _stats(x, mask)


# Registered through torch.library's low-level API, as rpc::sparse_conv_fwd
# is (kernels/sparse_conv.py says why): it runs only with gradients off
# (MaskedBatchNormFunction.forward, or a call that needs none).
# `lowp` (the bfloat16-read mode) comes last with a default, so artifacts
# exported before it existed, whose nodes do not name it, still load.
torch.library.define("rpc::masked_bn_apply",
                     "(Tensor x, Tensor mask, Tensor mean, Tensor var, Tensor weight, Tensor bias, "
                     "float eps, bool relu, bool row_mask, ScalarType out_dtype, "
                     "bool lowp=False) -> Tensor")


def _masked_bn_apply_cpu(x, mask, mean, var, weight, bias, eps, relu, row_mask, out_dtype,
                         lowp=False):
    # looked up per call: a wrapper of it counts
    _check_lowp("masked_batch_norm", x, lowp)
    return bn_apply_ref(x, mask, mean, var, weight, bias, eps, relu, row_mask, out_dtype, lowp)


def _masked_bn_apply_cuda(x, mask, mean, var, weight, bias, eps, relu, row_mask, out_dtype,
                          lowp=False):
    # checks, the stream and the counts live here: a traced call reaches only
    # the fake below, so it launches and counts nothing
    name = "masked_batch_norm"
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: output dtype {out_dtype} is not float32/bfloat16")
    _check_lowp(name, x, lowp)
    _check_rows(name, x, mask)
    n, c = x.shape
    _check_channels(name, c, x.device, mean, var, weight, bias)
    plan = row_plan(n, c, x.dtype, reduce=False)
    y = torch.empty((n, c), dtype=out_dtype, device=x.device)
    _rc(name, _fn("rpc_masked_bn_apply")(
        x.data_ptr(), mask.data_ptr(), mean.data_ptr(), var.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), y.data_ptr(), n, c, eps, _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
        plan.vec, int(relu), int(row_mask), plan.blocks, int(lowp), _stream(x.device)))
    _count("apply_kernel_lowp" if lowp else "apply_kernel", c, n)
    masked_batch_norm.launches += 1
    return y


def _masked_bn_apply_fake(x, mask, mean, var, weight, bias, eps, relu, row_mask, out_dtype,
                          lowp=False):
    return x.new_empty(x.shape, dtype=out_dtype)


torch.library.impl("rpc::masked_bn_apply", "cpu", _masked_bn_apply_cpu)
torch.library.impl("rpc::masked_bn_apply", "cuda", _masked_bn_apply_cuda)
torch.library.register_fake("rpc::masked_bn_apply", _masked_bn_apply_fake)


# The apply kernel as an operator that torch.export records as one node:
# `bn_apply_ref` on the CPU, the kernel on the card, an empty [N, C] of
# out_dtype while tracing.
masked_bn_apply = torch.ops.rpc.masked_bn_apply.default


def _bn_forward(x, mask, weight, bias, running_mean, running_var, training, momentum, eps, relu,
                row_mask, out_dtype, lowp=False):
    """(y, mean, var, count or None): the train mode's batch statistics or the
    eval mode's running ones, as the backward needs them. Eval mode touches
    no data pointer outside the apply operator, so it traces. `lowp`: the
    bfloat16-read mode (statistics and apply; the apply operator refuses it
    on float32 x)."""
    if x.device.type == "cpu":
        mean, var, cnt = _bn_stats_ref(x, mask, running_mean, running_var, training, momentum,
                                       lowp)
    elif training:
        _check_rows("masked_batch_norm", x, mask)
        _check_channels("masked_batch_norm", x.shape[1], x.device, running_mean, running_var)
        mean, var, cnt = _launch_stats("masked_batch_norm", x, mask, _stream(x.device),
                                       running_mean, running_var, momentum, lowp)
    else:
        mean, var, cnt = running_mean, running_var, None
    if lowp:
        y = masked_bn_apply(x, mask, mean, var, weight, bias, eps, relu, row_mask, out_dtype,
                            True)
    else:  # the node an artifact exported before the mode existed holds
        y = masked_bn_apply(x, mask, mean, var, weight, bias, eps, relu, row_mask, out_dtype)
    return y, mean, var, cnt


def masked_batch_norm_bwd(g: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
                          var: torch.Tensor, cnt: Optional[torch.Tensor], eps: float,
                          training: bool, relu: bool = False, row_mask: bool = False,
                          need_dx: bool = True, need_params: bool = True, lowp: bool = False):
    """(dx or None, d gamma or None, d beta or None) of the fused forward.

    `bwd_reduce` runs when the parameters need their gradient or train-mode
    dx needs the sums; `dx` when x needs its gradient. `lowp`: the forward
    ran the bfloat16-read mode, whose y the ReLU gate reads."""
    _check_lowp("masked_batch_norm_bwd", x, lowp)
    if x.device.type == "cpu":
        dx, dw, db = masked_batch_norm_bwd_ref(g, x, mask, weight, bias, mean, var, cnt, eps,
                                               training, relu, row_mask, lowp)
        return (dx if need_dx else None,) + ((dw, db) if need_params else (None, None))
    n, c = x.shape
    g = g.contiguous()
    dev = x.device
    _check_rows("masked_batch_norm_bwd", x, mask, g)
    _check_channels("masked_batch_norm_bwd", c, dev, weight, bias, mean, var)
    if training and need_dx and (cnt is None or cnt.device != dev
                                 or cnt.dtype != torch.float32):
        raise ValueError("masked_batch_norm_bwd: train mode needs the float32 count")
    stream = _stream(dev)
    dx = dw = db = sums = None
    if need_params or (training and need_dx):
        plan = row_plan(n, c, x.dtype, reduce=True)
        sums = torch.empty(2 * c, dtype=torch.float32, device=dev)
        ws, ticket = _workspace(dev, stream, plan.workspace_floats)
        _rc("masked_batch_norm_bwd", _fn("rpc_masked_bn_bwd_reduce")(
            x.data_ptr(), g.data_ptr(), mask.data_ptr(), mean.data_ptr(), var.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), sums.data_ptr(), ws, ticket, n, c, eps,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[g.dtype], plan.vec, int(relu), int(row_mask),
            plan.blocks, int(lowp), stream))
        _count("bwd_reduce_kernel", c, n)
        masked_batch_norm_bwd.reduce_launches += 1
        if need_params:
            db, dw = sums[:c], sums[c:]
    if need_dx:
        plan = row_plan(n, c, x.dtype, reduce=False)
        dx = torch.empty_like(x)
        _rc("masked_batch_norm_bwd", _fn("rpc_masked_bn_dx")(
            x.data_ptr(), g.data_ptr(), mask.data_ptr(), mean.data_ptr(), var.data_ptr(),
            _ptr(cnt) if training else None, weight.data_ptr(), bias.data_ptr(), _ptr(sums),
            dx.data_ptr(), n, c, eps, _DTYPE_CODES[x.dtype], _DTYPE_CODES[g.dtype], plan.vec,
            int(relu), int(row_mask), int(training), plan.blocks, int(lowp), stream))
        _count("dx_kernel", c, n)
    masked_batch_norm_bwd.launches += 1
    return dx, dw, db


class MaskedBatchNormFunction(torch.autograd.Function):
    """The fused MaskedBatchNorm (+ ReLU, + row mask) with its analytic backward."""

    @staticmethod
    def forward(ctx, x, mask, weight, bias, running, training, momentum, eps, relu, row_mask,
                out_dtype, lowp):
        # running: the (mean, var) buffers as a tuple, which autograd does not
        # take for inputs: the statistics kernel updates them in place
        y, mean, var, cnt = _bn_forward(x, mask, weight, bias, *running, training, momentum, eps,
                                        relu, row_mask, out_dtype, lowp)
        ctx.save_for_backward(x, mask, weight, bias, mean, var, cnt)
        ctx.cfg = (eps, training, relu, row_mask, lowp)
        return y

    @staticmethod
    def backward(ctx, g):
        x, mask, weight, bias, mean, var, cnt = ctx.saved_tensors
        eps, training, relu, row_mask, lowp = ctx.cfg
        need = ctx.needs_input_grad
        dx, dw, db = masked_batch_norm_bwd(g, x, mask, weight, bias, mean, var, cnt, eps,
                                           training, relu, row_mask, need_dx=need[0],
                                           need_params=need[2] or need[3], lowp=lowp)
        return dx, None, dw, db, None, None, None, None, None, None, None, None


def masked_batch_norm(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                      training: bool, momentum: float = 0.1, eps: float = 1e-3,
                      relu: bool = False, row_mask: bool = False,
                      out_dtype: Optional[torch.dtype] = None, lowp: bool = False) -> torch.Tensor:
    """MaskedBatchNorm of x [N, C] over the rows where mask [N] is set: batch
    statistics in training (running statistics updated in place), running
    ones in eval; then ReLU and zeroed masked rows when asked; y in
    `out_dtype` (x's dtype by default). `lowp`: the bfloat16-read mode
    (bfloat16 x). Differentiable in x, weight and bias; a call that needs no
    gradient launches the kernels directly."""
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return MaskedBatchNormFunction.apply(x, mask, weight, bias, (running_mean, running_var),
                                             training, momentum, eps, relu, row_mask, out_dtype,
                                             lowp)
    return _bn_forward(x, mask, weight, bias, running_mean, running_var, training, momentum, eps,
                       relu, row_mask, out_dtype, lowp)[0]


for _f in (masked_stats, masked_stats_bwd, masked_batch_norm, masked_batch_norm_bwd):
    _f.launches = 0
masked_batch_norm_bwd.reduce_launches = 0
