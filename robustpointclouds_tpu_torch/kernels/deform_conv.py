"""The deformable 2D convolution (DCNv1) forward of CenterPoint's DCN head.

`deform_conv2d(x [B, C, H, W], offset [B, dg * 2 * k * k, H, W], weight
[Cout, C / groups, k, k], groups, deform_groups) -> [B, Cout, H, W]`, stride
1, padding (k - 1) // 2, no bias. `offset` is the offset conv's output in
mmcv's channel order [deform group, tap, (dy, dx)]; taps are row-major
(ky, kx). Tap t of output pixel (h, w) samples x bilinearly at (h + ky_t +
dy, w + kx_t + dx), a corner outside the map reading zero (mmcv's border
rule); input channel c samples at the offsets of deform group c // (C / dg),
and output group i reads input channel group i only.

It is the operator `rpc::deform_conv2d` (torch.library, registered as
`rpc::greedy_keep` is in kernels/greedy_nms.py): a CPU tensor takes the plain
twin `deform_conv2d_ref` (four gathers into a col of [B*H*W, K, C], then an
einsum), which is also the route for anything that needs a gradient
(nn/deform_conv.DeformConv2d calls it directly then: the operator has no
autograd kernel); a CUDA tensor takes the kernel of csrc/deform_conv.cu, one
launch a call with no col in device memory, or the call raises; the fake
gives the output's shape and type, so torch.export records one node a
convolution and an exported program launches the kernel. `KERNEL_LAUNCHES`
counts the calls by route, "kernel" or "plain" (never while tracing).
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from ._build import load_library

KERNEL_LAUNCHES: Counter = Counter()  # route ("kernel" / "plain") -> calls


def bilinear_gather(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Sample x [B, H, W, C] at fractional positions (py, px) [B, H, W, K]
    -> [B, H, W, K, C]; a corner outside the map contributes zero."""
    b, h, w, c = x.shape
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy = (py - y0)[..., None]
    wx = (px - x0)[..., None]
    flat = x.reshape(b * h * w, c)
    base = torch.arange(b, device=x.device).view(b, 1, 1, 1) * (h * w)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        g = flat[base + yc * w + xc]
        return torch.where(valid[..., None], g, torch.zeros_like(g))

    return (tap(y0, x0) * (1 - wy) * (1 - wx) + tap(y0, x0 + 1) * (1 - wy) * wx
            + tap(y0 + 1, x0) * wy * (1 - wx) + tap(y0 + 1, x0 + 1) * wy * wx)


def deform_conv2d_ref(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor, groups: int,
                      deform_groups: int) -> torch.Tensor:
    """The plain twin: the taps gathered into col [B*H*W, K, C], then one
    grouped einsum. Differentiable in x, offset and weight."""
    b, c, h, w = x.shape
    k = weight.shape[-1]
    g, dg = groups, deform_groups
    taps = k * k
    off = offset.permute(0, 2, 3, 1).reshape(b, h, w, dg, taps, 2)
    r = torch.arange(k, dtype=x.dtype, device=x.device) - (k - 1) // 2
    ky = r.repeat_interleave(k)  # tap order row-major (ky, kx)
    kx = r.repeat(k)
    gy = torch.arange(h, dtype=x.dtype, device=x.device).view(1, h, 1, 1)
    gx = torch.arange(w, dtype=x.dtype, device=x.device).view(1, 1, w, 1)
    xh = x.permute(0, 2, 3, 1)
    cdg = c // dg
    col = torch.cat([
        bilinear_gather(xh[..., d * cdg:(d + 1) * cdg], gy + ky + off[..., d, :, 0],
                        gx + kx + off[..., d, :, 1])
        for d in range(dg)], dim=-1)  # [B, H, W, K, C]
    cout = weight.shape[0]
    col = col.reshape(b * h * w, taps, g, c // g)
    wt = weight.to(x.dtype).reshape(g, cout // g, c // g, taps)
    out = torch.einsum("nkgc,gock->ngo", col, wt).reshape(b, h, w, cout)
    return out.permute(0, 3, 1, 2)


def _check(x, offset, weight, groups, deform_groups) -> None:
    if not (x.dtype == offset.dtype == weight.dtype and x.dtype.is_floating_point):
        raise TypeError(f"deform_conv2d: x, offset and weight must share one floating type, got "
                        f"{x.dtype}/{offset.dtype}/{weight.dtype}")
    if x.dim() != 4 or offset.dim() != 4 or weight.dim() != 4:
        raise ValueError("deform_conv2d: x, offset and weight must be 4-d")
    b, c, h, w = x.shape
    cout, cg, k, k2 = weight.shape
    if (groups < 1 or deform_groups < 1 or c % groups or cout % groups or c % deform_groups
            or cg != c // groups or k != k2):
        raise ValueError(f"deform_conv2d: weight {tuple(weight.shape)} does not fit x "
                         f"{tuple(x.shape)} at groups {groups}, deform_groups {deform_groups}")
    if tuple(offset.shape) != (b, deform_groups * 2 * k * k, h, w):
        raise ValueError(f"deform_conv2d: offset {tuple(offset.shape)} must be "
                         f"{(b, deform_groups * 2 * k * k, h, w)}")


def _lib() -> ctypes.CDLL:
    lib = load_library("deform_conv")
    fn = lib.rpc_deform_conv2d
    if fn.argtypes is None:  # pointers and the stream must not pass as 32-bit ints
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, p] + [i64] * 8 + [p]
        fn.restype = ctypes.c_int
    return lib


torch.library.define("rpc::deform_conv2d", "(Tensor x, Tensor offset, Tensor weight, "
                      "int groups, int deform_groups) -> Tensor")


def _deform_conv2d_cpu(x, offset, weight, groups, deform_groups):
    _check(x, offset, weight, groups, deform_groups)
    KERNEL_LAUNCHES["plain"] += 1
    # contiguous NCHW, as the kernel's output and the fake's
    return deform_conv2d_ref(x, offset, weight, groups, deform_groups).contiguous()


def _deform_conv2d_cuda(x, offset, weight, groups, deform_groups):
    # checks, the stream and the count live here: a traced call reaches only
    # the fake below, so it launches and counts nothing
    _check(x, offset, weight, groups, deform_groups)
    if x.dtype != torch.float32:
        raise TypeError(f"deform_conv2d: the kernel takes float32, got {x.dtype}")
    if not (offset.device == weight.device == x.device):
        raise ValueError("deform_conv2d: x, offset and weight must lie on one CUDA device")
    if not (x.is_contiguous() and offset.is_contiguous() and weight.is_contiguous()):
        raise ValueError("deform_conv2d: x, offset and weight must be contiguous")
    b, c, h, w = x.shape
    cout, _, k, _ = weight.shape
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rc = _lib().rpc_deform_conv2d(x.data_ptr(), offset.data_ptr(), weight.data_ptr(),
                                  out.data_ptr(), b, c, h, w, cout, k, groups, deform_groups,
                                  torch._C._cuda_getCurrentRawStream(x.device.index))
    if rc != 0:
        raise RuntimeError(f"deform_conv2d: kernel launch failed with cudaError {rc}")
    KERNEL_LAUNCHES["kernel"] += 1
    return out


def _deform_conv2d_fake(x, offset, weight, groups, deform_groups):
    return x.new_empty((x.shape[0], weight.shape[0], x.shape[2], x.shape[3]))


torch.library.impl("rpc::deform_conv2d", "cpu", _deform_conv2d_cpu)
torch.library.impl("rpc::deform_conv2d", "cuda", _deform_conv2d_cuda)
torch.library.register_fake("rpc::deform_conv2d", _deform_conv2d_fake)

deform_conv2d_op = torch.ops.rpc.deform_conv2d.default


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor, groups: int = 1,
                  deform_groups: int = 1) -> torch.Tensor:
    """The forward through the operator rpc::deform_conv2d; no gradient."""
    if x.device.type not in ("cpu", "cuda"):  # a meta tensor would get the fake's empty output
        raise ValueError(f"deform_conv2d: inputs on {x.device}: neither the plain twin nor the "
                         "kernel takes them")
    return deform_conv2d_op(x, offset, weight, groups, deform_groups)
