"""Row gathers out[i] = x[idx[i]], four ways: the port of the Pallas gather probes.

The counterpart of the kernels in robustpointclouds_tpu/tools/
probe_mosaic_gather.py, which asked which gather formulations Mosaic lowers
on a TPU and how fast the winner runs at the sparse conv's table size:

  gather_rows      `k_take` and the tiled `kg`: 16-byte vector row copies
  gather_elems     `k_tal` (take_along_axis): one thread per element
  gather_row_loop  `k_loop`: blocks stage their indices and loop over rows
  gather_onehot    `k_onehot`: onehot(idx) @ x on the tensor cores

Contract: x [N, C] float32 or bfloat16, idx [M] int32 in [0, N]; index N
(or anything outside [0, N)) reads a zero row, as the zero-padded table of
the probe's XLA yardstick and the sparse conv's miss index do. The copies
are exact; the one-hot product carries x's words through the tensor cores as
integer planes (`onehot_planes`), exact for every word, non-finite ones
included, where the plain float product gives NaN in a column that holds an
Inf or NaN (see csrc/gather_probe.cu).

A CUDA tensor launches the hand-written kernel (csrc/gather_probe.cu, built
on first use) and counts the launch on the wrapper; a CPU tensor takes the
plain PyTorch versions (`gather_ref`, `gather_onehot_ref`), which the CPU
tests hold against numpy and the JAX formulas. Anything else raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from ._build import load_library

_DTYPES = (torch.float32, torch.bfloat16)
_SMS = 132  # an H100's SMs
_THREADS = 256
_LOOP_STAGE = 4096  # indices a row-loop block stages at once
_LOOP_BLOCKS_PER_SM = 4
_OH_TILE = 16  # a warp's one-hot output tile: 16 rows x 16 columns
_OH_WARPS = 4  # a one-hot block: row tiles x k splits
_OH_PLANE_BITS = 10
_OH_PLANES = {4: 4, 2: 2}  # 10-bit planes of a float32 / bfloat16 word


def gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the gather over the zero-padded table."""
    return torch.cat([x, x.new_zeros(1, x.shape[1])], 0)[idx.long()]


def gather_onehot_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the one-hot form: onehot(idx) [M, N] @ x."""
    n = x.shape[0]
    onehot = F.one_hot(idx.long(), n + 1)[:, :n]  # index N: an all-zero row
    return onehot.to(x.dtype) @ x


def _words(x: torch.Tensor) -> torch.Tensor:
    """x's raw words as non-negative int64."""
    if x.dtype == torch.float32:
        return x.view(torch.int32).long() & 0xFFFFFFFF
    return x.view(torch.int16).long() & 0xFFFF


def onehot_planes(x: torch.Tensor) -> torch.Tensor:
    """[P, N, C] float16: x's words cut into 10-bit planes (float32: four,
    bfloat16: two), plane value v as the fp16 1024 + v (bits 0x6400 | v),
    exact and normal."""
    w, mask = _words(x), (1 << _OH_PLANE_BITS) - 1
    return torch.stack([(((w >> (p * _OH_PLANE_BITS)) & mask) + 1024).to(torch.float16)
                        for p in range(_OH_PLANES[x.element_size()])])


def onehot_join(sums: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's epilogue: [P, M, C] float32 sums, each 1024 + v or 0 ->
    [M, C] of `dtype`, the planes' low 10 bits put back together."""
    word = torch.zeros(sums.shape[1:], dtype=torch.int64)
    for p in range(sums.shape[0]):
        word |= (sums[p].long() & ((1 << _OH_PLANE_BITS) - 1)) << (p * _OH_PLANE_BITS)
    if dtype == torch.float32:
        return (word - ((word >> 31) << 32)).to(torch.int32).view(torch.float32)
    return (word - ((word >> 15) << 16)).to(torch.int16).view(torch.bfloat16)


def gather_onehot_planes_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain PyTorch: fp16 one-hot
    times fp16 planes, float32 sums (each 1024 + v or 0), words joined."""
    n = x.shape[0]
    onehot = F.one_hot(idx.long(), n + 1)[:, :n].to(torch.float16)
    sums = torch.stack([onehot.float() @ p.float() for p in onehot_planes(x)])
    return onehot_join(sums, x.dtype)


class RowLoopPlan(NamedTuple):
    """Launch of the row loop (csrc/gather_probe.cu, rpc_gather_row_loop)."""
    vec: int  # bytes each thread moves per load and store: 16, 8, 4 or 2
    lanes: int  # threads per row
    slots: int  # rows a block covers at once (lanes * slots <= 256)
    rows_per_block: int  # a chunk of rows, its indices staged in shared memory
    blocks: int  # grid; blocks stride over the chunks


@functools.lru_cache(maxsize=256)
def row_loop_plan(m: int, c: int, elem_bytes: int, align: int = 256) -> RowLoopPlan:
    """The widest vector that divides the row's bytes and `align` (the bases'
    alignment), up to a warp per row, and chunks that give each SM about
    _LOOP_BLOCKS_PER_SM blocks: a multiple of the block's rows at once, at
    most _LOOP_STAGE."""
    row_bytes = c * elem_bytes
    vec = next(v for v in (16, 8, 4, 2) if row_bytes % v == 0 and align % v == 0)
    lanes = min(row_bytes // vec, 32)
    slots = _THREADS // lanes
    target = -(-max(m, 1) // (_SMS * _LOOP_BLOCKS_PER_SM))
    rows = min(-(-target // slots) * slots, _LOOP_STAGE // slots * slots)
    chunks = -(-max(m, 1) // rows)
    return RowLoopPlan(vec, lanes, slots, rows, min(chunks, _SMS * _LOOP_BLOCKS_PER_SM))


class OnehotPlan(NamedTuple):
    """Launch of the tensor-core one-hot product (rpc_gather_onehot)."""
    row_warps: int  # 16-row output tiles per block of four warps; the rest split k
    row_tiles: int  # grid x: blocks of 16 * row_warps rows
    col_tiles: int  # grid y: 16-column tiles
    vec: int  # 16: the table staged by 16-byte cp.async; 0: word by word
    planes: int  # 10-bit planes per word, each one product


@functools.lru_cache(maxsize=256)
def onehot_plan(m: int, c: int, elem_bytes: int, align: int = 256) -> OnehotPlan:
    """Four warps a block: 4 (or 2) output tiles stacked along the rows
    where the grid still has a block for every SM, else one tile whose k
    range the four warps split."""
    col_tiles = -(-c // _OH_TILE)
    rw = next((w for w in (4, 2) if -(-m // (_OH_TILE * w)) * col_tiles >= _SMS), 1)
    vec = 16 if (c * elem_bytes) % 16 == 0 and align % 16 == 0 else 0
    return OnehotPlan(rw, -(-m // (_OH_TILE * rw)), col_tiles, vec, _OH_PLANES[elem_bytes])


# ---- the card's kernels

_FNS: Dict[str, object] = {}


def _fn(name: str):
    """A C entry point of the library, bound (argument types set) once."""
    fn = _FNS.get(name)
    if fn is None:
        lib = load_library("gather_probe")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        head = [p, p, p, i64, i64]  # x, idx, out, M, N; pointers must not pass as 32-bit ints
        plan = ctypes.POINTER(ctypes.c_int64)
        args = {"rpc_gather_rows": head + [i, p],
                "rpc_gather_elems": head + [i64, i, p],
                "rpc_gather_row_loop": head + [plan, p],
                "rpc_gather_onehot": head + [plan, p]}
        for key, types in args.items():
            getattr(lib, key).argtypes = types
            getattr(lib, key).restype = i
            _FNS[key] = getattr(lib, key)
        fn = _FNS[name]
    return fn


@functools.lru_cache(maxsize=256)
def _plan_args(plan_fn, m: int, c: int, elem_bytes: int, align: int):
    """The int64 array a C entry point takes for its plan: C, the element
    bytes, then `plan_fn`'s fields in order (one argument instead of one per
    field: ctypes converts each argument on every call)."""
    plan = plan_fn(m, c, elem_bytes, align)
    return (ctypes.c_int64 * (2 + len(plan)))(c, elem_bytes, *plan)


def _stream(device_index: int) -> int:
    """The current stream of a CUDA device as the raw handle the kernels take
    (the call torch's own generated kernels use, without a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _check(name: str, x: torch.Tensor, idx: torch.Tensor) -> None:
    if not (x.is_cuda and idx.get_device() == x.get_device()):
        raise ValueError(f"{name}: x and idx must lie on one CUDA device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {idx.dtype}")
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{name}: x [N, C] and idx [M] expected, got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def _launch(name: str, x: torch.Tensor, idx: torch.Tensor, *extra) -> torch.Tensor:
    """Allocate the output and launch `name`(x, idx, out, M, N, *extra, stream)."""
    m = idx.shape[0]
    out = x.new_empty((m, x.shape[1]))
    if m:
        rc = _fn(name)(x.data_ptr(), idx.data_ptr(), out.data_ptr(), m, x.shape[0], *extra,
                       _stream(x.get_device()))
        if rc != 0:
            raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    return out


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, C], idx [M] -> [M, C]; rows of C * itemsize bytes, a multiple of 16."""
    if x.is_cpu:
        return gather_ref(x, idx)
    _check("gather_rows", x, idx)
    row_bytes = x.shape[1] * x.element_size()
    if row_bytes % 16 or x.data_ptr() % 16:
        raise ValueError(f"gather_rows: rows of {row_bytes} bytes are not 16-byte vectors")
    out = _launch("rpc_gather_rows", x, idx, row_bytes // 16)
    gather_rows.launches += 1
    return out


def gather_elems(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, C], idx [M] -> [M, C], one thread per output element."""
    if x.is_cpu:
        return gather_ref(x, idx)
    _check("gather_elems", x, idx)
    out = _launch("rpc_gather_elems", x, idx, x.shape[1], x.element_size())
    gather_elems.launches += 1
    return out


def _align(x: torch.Tensor) -> int:
    """The largest power of two up to 256 that divides x's base address."""
    ptr = x.data_ptr()
    return min(ptr & -ptr, 256) if ptr else 256


def gather_row_loop(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, C], idx [M] -> [M, C]: blocks stage their rows' indices and loop
    over the rows, the grid sized to the card (row_loop_plan)."""
    if x.is_cpu:
        return gather_ref(x, idx)
    _check("gather_row_loop", x, idx)
    plan = _plan_args(row_loop_plan, idx.shape[0], x.shape[1], x.element_size(), _align(x))
    out = _launch("rpc_gather_row_loop", x, idx, plan)
    gather_row_loop.launches += 1
    return out


def gather_onehot(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """onehot(idx) [M, N] @ x [N, C] -> [M, C] on the tensor cores (onehot_plan)."""
    if x.is_cpu:
        return gather_onehot_ref(x, idx)
    _check("gather_onehot", x, idx)
    plan = _plan_args(onehot_plan, idx.shape[0], x.shape[1], x.element_size(), _align(x))
    out = _launch("rpc_gather_onehot", x, idx, plan)
    gather_onehot.launches += 1
    return out


gather_rows.launches = 0
gather_elems.launches = 0
gather_row_loop.launches = 0
gather_onehot.launches = 0
