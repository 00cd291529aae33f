"""The greedy NMS keep-mask: the sweep every NMS of the port ends in.

`greedy_keep(over [R, N, N] bool, valid [R, N] bool) -> keep [R, N] bool`,
boxes in descending score order along N:

    keep[r, i] = valid[r, i] and not any(keep[r, j] and over[r, j, i] for j < i)

so `over[r, j, i]` means "j suppresses i" (read row by row of j: an
asymmetric relation gives the loop's answer), and a box that is not kept
suppresses nothing. The JAX package runs it as a `lax.fori_loop`
(robustpointclouds_tpu/ops/nms.py:36), one device loop under XLA.

It is the operator `rpc::greedy_keep` (torch.library, registered as
`rpc::sparse_conv_fwd` is in kernels/sparse_conv.py): a CPU tensor takes
the plain version `greedy_keep_ref`, N rounds of tensor ops over all R rows
at once (about seven launches a round); a CUDA tensor takes the kernel of
csrc/greedy_nms.cu, one launch for the whole call, or the call raises; the
fake gives the output's shape and type, so torch.export records one node
and an exported program launches the kernel. `KERNEL_LAUNCHES` counts the
calls by route, "kernel" or "plain" (never while tracing).
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from ._build import load_library

_SMEM_BYTES = 48 * 1024  # csrc kSmemBytes: a row's words above this go to a global scratch
KERNEL_LAUNCHES: Counter = Counter()  # route ("kernel" / "plain") -> calls


def greedy_keep_ref(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one round of tensor ops a box, every row at once."""
    n = over.shape[-1]
    idx = torch.arange(n, device=over.device)
    keep = torch.zeros_like(valid)
    for i in range(n):
        earlier = (idx < i) & keep
        suppressed = torch.any(earlier & over[..., :, i], dim=-1)
        keep[..., i] = valid[..., i] & ~suppressed
    return keep


def _check(over: torch.Tensor, valid: torch.Tensor) -> None:
    if over.dtype != torch.bool or valid.dtype != torch.bool:
        raise TypeError(f"greedy_keep: over and valid must be bool, got {over.dtype}/{valid.dtype}")
    if over.dim() != 3 or valid.dim() != 2 or over.shape != (*valid.shape, valid.shape[-1]):
        raise ValueError(f"greedy_keep: over {tuple(over.shape)} must be [R, N, N] and valid "
                         f"{tuple(valid.shape)} [R, N]")


def _lib() -> ctypes.CDLL:
    lib = load_library("greedy_nms")
    fn = lib.rpc_greedy_keep
    if fn.argtypes is None:  # pointers and the stream must not pass as 32-bit ints
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, p, i64, i64, p]
        fn.restype = ctypes.c_int
        lib.rpc_greedy_keep_words.argtypes = [i64]
        lib.rpc_greedy_keep_words.restype = i64
    return lib


torch.library.define("rpc::greedy_keep", "(Tensor over, Tensor valid) -> Tensor")


def _greedy_keep_cpu(over, valid):
    _check(over, valid)
    KERNEL_LAUNCHES["plain"] += 1
    return greedy_keep_ref(over, valid)


def _greedy_keep_cuda(over, valid):
    # checks, the scratch, the stream and the count live here: a traced call
    # reaches only the fake below, so it launches and counts nothing
    _check(over, valid)
    if valid.device != over.device:
        raise ValueError("greedy_keep: over and valid must lie on one CUDA device")
    if not (over.is_contiguous() and valid.is_contiguous()):
        raise ValueError("greedy_keep: over and valid must be contiguous")
    rows, n = valid.shape
    keep = torch.empty((rows, n), dtype=torch.bool, device=valid.device)
    if keep.numel() == 0:
        return keep
    lib = _lib()
    words = lib.rpc_greedy_keep_words(n)
    scratch = (None if words * 8 <= _SMEM_BYTES else
               torch.empty(rows * words, dtype=torch.int64, device=valid.device))
    rc = lib.rpc_greedy_keep(over.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                             None if scratch is None else scratch.data_ptr(), rows, n,
                             torch._C._cuda_getCurrentRawStream(valid.device.index))
    if rc != 0:
        raise RuntimeError(f"greedy_keep: kernel launch failed with cudaError {rc}")
    KERNEL_LAUNCHES["kernel"] += 1
    return keep


def _greedy_keep_fake(over, valid):
    return valid.new_empty(valid.shape)


torch.library.impl("rpc::greedy_keep", "cpu", _greedy_keep_cpu)
torch.library.impl("rpc::greedy_keep", "cuda", _greedy_keep_cuda)
torch.library.register_fake("rpc::greedy_keep", _greedy_keep_fake)

greedy_keep_op = torch.ops.rpc.greedy_keep.default


def greedy_keep(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """over [R, N, N] bool, valid [R, N] bool -> keep [R, N] bool, through
    the operator rpc::greedy_keep."""
    if valid.device.type not in ("cpu", "cuda"):  # a meta tensor would get the fake's empty mask
        raise ValueError(f"greedy_keep: inputs on {valid.device}: neither the plain version "
                         "nor the kernel takes them")
    return greedy_keep_op(over, valid)
