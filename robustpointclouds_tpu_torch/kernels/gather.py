"""Row gathers out[i] = x[idx[i]], four ways: the port of the Pallas gather probes.

The counterpart of the kernels in robustpointclouds_tpu/tools/
probe_mosaic_gather.py, which asked which gather formulations Mosaic lowers
on a TPU and how fast the winner runs at the sparse conv's table size:

  gather_rows      `k_take` and the tiled `kg`: 16-byte vector row copies
  gather_elems     `k_tal` (take_along_axis): one thread per element
  gather_row_loop  `k_loop`: one block, indices staged, rows in sequence
  gather_onehot    `k_onehot`: onehot(idx) @ x, a tiled float32 product

Contract: x [N, C] float32 or bfloat16, idx [M] int32 in [0, N]; index N
(or anything outside [0, N)) reads a zero row, as the zero-padded table of
the probe's XLA yardstick and the sparse conv's miss index do. The copies
are exact; the one-hot product sums one non-zero product in float32, exact
too.

A CUDA tensor launches the hand-written kernel (csrc/gather_probe.cu, built
on first use) and counts the launch on the wrapper; a CPU tensor takes the
plain PyTorch versions (`gather_ref`, `gather_onehot_ref`), which the CPU
tests hold against numpy and the JAX formulas. Anything else raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the gather over the zero-padded table."""
    return torch.cat([x, x.new_zeros(1, x.shape[1])], 0)[idx.long()]


def gather_onehot_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the one-hot form: onehot(idx) [M, N] @ x."""
    n = x.shape[0]
    onehot = F.one_hot(idx.long(), n + 1)[:, :n]  # index N: an all-zero row
    return onehot.to(x.dtype) @ x


def _lib() -> ctypes.CDLL:
    lib = load_library("gather_probe")
    if lib.rpc_gather_rows.argtypes is None:  # pointers and the stream must not pass as 32-bit ints
        head = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2  # x, idx, out, M, N
        lib.rpc_gather_rows.argtypes = head + [ctypes.c_int, ctypes.c_void_p]
        for name in ("rpc_gather_elems", "rpc_gather_row_loop", "rpc_gather_onehot"):
            getattr(lib, name).argtypes = head + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        for name in ("rpc_gather_rows", "rpc_gather_elems", "rpc_gather_row_loop",
                     "rpc_gather_onehot"):
            getattr(lib, name).restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, idx: torch.Tensor) -> None:
    if not (x.is_cuda and idx.device == x.device):
        raise ValueError(f"{name}: x and idx must lie on one CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {idx.dtype}")
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{name}: x [N, C] and idx [M] expected, got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def _launch(name: str, fn: str, x: torch.Tensor, idx: torch.Tensor, *extra: int) -> torch.Tensor:
    """Allocate the output and launch `fn`(x, idx, out, M, N, *extra, stream)."""
    out = torch.empty((idx.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    if idx.shape[0] == 0:
        return out
    rc = getattr(_lib(), fn)(x.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
                             x.shape[0], *extra, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
    return out


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, C], idx [M] -> [M, C]; rows of C * itemsize bytes, a multiple of 16."""
    if x.device.type == "cpu":
        return gather_ref(x, idx)
    _check("gather_rows", x, idx)
    row_bytes = x.shape[1] * x.element_size()
    if row_bytes % 16 or x.data_ptr() % 16:
        raise ValueError(f"gather_rows: rows of {row_bytes} bytes are not 16-byte vectors")
    out = _launch("gather_rows", "rpc_gather_rows", x, idx, row_bytes // 16)
    gather_rows.launches += 1
    return out


def gather_elems(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, C], idx [M] -> [M, C], one thread per output element."""
    if x.device.type == "cpu":
        return gather_ref(x, idx)
    _check("gather_elems", x, idx)
    out = _launch("gather_elems", "rpc_gather_elems", x, idx, x.shape[1], x.element_size())
    gather_elems.launches += 1
    return out


def gather_row_loop(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, C], idx [M] -> [M, C], one block copying the rows in sequence."""
    if x.device.type == "cpu":
        return gather_ref(x, idx)
    _check("gather_row_loop", x, idx)
    out = _launch("gather_row_loop", "rpc_gather_row_loop", x, idx, x.shape[1],
                  x.element_size())
    gather_row_loop.launches += 1
    return out


def gather_onehot(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """onehot(idx) [M, N] @ x [N, C] -> [M, C], float32 accumulation."""
    if x.device.type == "cpu":
        return gather_onehot_ref(x, idx)
    _check("gather_onehot", x, idx)
    out = _launch("gather_onehot", "rpc_gather_onehot", x, idx, x.shape[1],
                  _DTYPE_CODES[x.dtype])
    gather_onehot.launches += 1
    return out


gather_rows.launches = 0
gather_elems.launches = 0
gather_row_loop.launches = 0
gather_onehot.launches = 0
