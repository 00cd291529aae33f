"""The precision the plain reference computes its products in.

The reference computes in float32 with TF32 off. Its control computes in the
next precision below the one each part of the configuration states: the parts
stated in bfloat16 (sparse encoder, dense body, anchor head, adversary MLP)
take float8 e4m3 operands, any part stated in float32 bfloat16 operands.
Only the operands of the products (conv and linear inputs and weights) and
its output are rounded in the forward, as the program stores its products'
outputs in the stated precision, and the gradient arriving at each
product's output in the backward (float8 e5m2 for the bfloat16 parts, as
float8 training recipes carry gradients, bfloat16 for the float32 parts); each float8 tensor has a per-tensor scale. Sums, statistics and
every other operation stay float32.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_MODE = contextvars.ContextVar("plain_precision", default="float32")
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def mode() -> str:
    return _MODE.get()


@contextlib.contextmanager
def use(name: str):
    """Compute the products inside the block in `name`: "float32" (the
    reference) or "control" (one precision below the configuration's)."""
    if name not in ("float32", "control"):
        raise ValueError(f"unknown precision {name!r}")
    token = _MODE.set(name)
    try:
        yield
    finally:
        _MODE.reset(token)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _round_e5m2(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E5M2_MAX
    return (x / scale).to(torch.float8_e5m2).to(torch.float32) * scale


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, fwd, bwd):
        ctx.bwd = bwd
        return fwd(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g.float()), None, None


def body_out(y: torch.Tensor) -> torch.Tensor:
    """A product's output in a part stated in bfloat16: rounded to float8
    e4m3, its gradient to float8 e5m2."""
    if _MODE.get() == "float32":
        return y
    return _RoundOut.apply(y, _round_fp8, _round_e5m2)


def full_out(y: torch.Tensor) -> torch.Tensor:
    """A product's output in a part stated in float32: it and its gradient
    rounded to bfloat16."""
    if _MODE.get() == "float32":
        return y
    return _RoundOut.apply(y, _round_bf16, _round_bf16)


def body(x: torch.Tensor) -> torch.Tensor:
    """An operand of a part the configuration states in bfloat16."""
    x = x.float()
    if _MODE.get() == "float32":
        return x
    return _StraightThrough.apply(x, _round_fp8)


def full(x: torch.Tensor) -> torch.Tensor:
    """An operand of a part the configuration states in float32."""
    x = x.float()
    if _MODE.get() == "float32":
        return x
    return _StraightThrough.apply(x, _round_bf16)
