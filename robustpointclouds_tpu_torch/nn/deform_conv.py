"""Deformable 2D convolution (DCNv1) as a gather in plain torch (counterpart of robustpointclouds_tpu/nn/deform_conv.py).

mmdet3d's DCN CenterHead (the reference's `...head-dcn-circlenms` base
config) runs a DeformConv2d feature adaptation in front of each head
branch. Here, as in the JAX package: an offset conv (a plain conv, zero at
initialisation) -> bilinear sampling of the K taps at p + p_k + offset_k
(samples outside the map read zero, mmcv's border rule) -> one img2col
matmul per channel group. The JAX package runs it as plain XLA, not Pallas,
so it has no hand kernel here either. Zero offsets reduce it to a plain 3x3
conv.

Weights keep mmcv's layout: `weight` [Cout, Cin / groups, kh, kw] and
`conv_offset` (Conv2d, 2 * K offsets (dy, dx) per deform group, channel
order [deform group, tap, (y, x)]). Tensors are NCHW.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


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


class DeformConv2d(nn.Module):
    """3x3 deformable conv (mmcv DeformConv2dPack(in, out, 3, padding=1,
    groups, deform_groups), no bias): offsets from `conv_offset`, sampling
    by gather. `groups`: output group i reads input channel group i only;
    `deform_groups`: each input channel block samples at its own offsets."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, groups: int = 1,
                 deform_groups: int = 1):
        super().__init__()
        if in_channels % groups or out_channels % groups or in_channels % deform_groups:
            raise ValueError("channels must divide into groups and deform groups")
        self.kernel, self.groups, self.deform_groups = kernel, groups, deform_groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kernel, kernel))
        self.conv_offset = nn.Conv2d(in_channels, deform_groups * 2 * kernel * kernel, kernel,
                                     padding=(kernel - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        k, g, dg = self.kernel, self.groups, self.deform_groups
        taps = k * k
        off = self.conv_offset(x).permute(0, 2, 3, 1).reshape(b, h, w, dg, taps, 2)
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
        cout = self.weight.shape[0]
        col = col.reshape(b * h * w, taps, g, c // g)
        wt = self.weight.to(x.dtype).reshape(g, cout // g, c // g, taps)
        out = torch.einsum("nkgc,gock->ngo", col, wt).reshape(b, h, w, cout)
        return out.permute(0, 3, 1, 2)


def dcn_kernel_to_weight(kernel, groups: int = 1) -> torch.Tensor:
    """The JAX DeformConv2d kernel ([K*Cin, Cout], or [g, K*Cin/g, Cout/g]
    for groups > 1; taps major, channels minor) -> mmcv's [Cout, Cin/g, k, k]."""
    kernel = torch.as_tensor(np.array(kernel, np.float32))
    if groups == 1:
        kernel = kernel[None]
    g, kc, og = kernel.shape
    k = 3
    cg = kc // (k * k)
    # [g, (ky, kx, c), o] -> [g, o, c, ky, kx] -> [g*o, c, ky, kx]
    return kernel.reshape(g, k, k, cg, og).permute(0, 4, 3, 1, 2).reshape(g * og, cg, k, k)
