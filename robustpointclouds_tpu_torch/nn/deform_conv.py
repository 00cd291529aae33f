"""Deformable 2D convolution (DCNv1) (counterpart of robustpointclouds_tpu/nn/deform_conv.py).

mmdet3d's DCN CenterHead (the reference's `...head-dcn-circlenms` base
config) runs a DeformConv2d feature adaptation in front of each head
branch. Here, as in the JAX package: an offset conv (a plain conv, zero at
initialisation) -> bilinear sampling of the K taps at p + p_k + offset_k
(samples outside the map read zero, mmcv's border rule) -> one img2col
product per channel group. Zero offsets reduce it to a plain 3x3 conv.

Two routes after the offset conv, chosen from the inputs:
  * where autograd has to differentiate through the convolution (grad mode
    on and x, the offsets or the weight requiring a gradient: a train step,
    PGD / FGSM on CenterPoint), the plain twin
    `kernels/deform_conv.deform_conv2d_ref`: the taps gathered into a col
    of [B*H*W, K, C] and one einsum, as the JAX package's plain XLA;
  * otherwise (serving under no_grad, the `.pt2` export) the operator
    `rpc::deform_conv2d`: on the card one launch of csrc/deform_conv.cu,
    sampling fused into the grouped product with no col in device memory;
    on the CPU the same twin. `kernels.deform_conv.KERNEL_LAUNCHES` counts
    its calls.

Weights keep mmcv's layout: `weight` [Cout, Cin / groups, kh, kw] and
`conv_offset` (Conv2d, 2 * K offsets (dy, dx) per deform group, channel
order [deform group, tap, (y, x)]). Tensors are NCHW.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..kernels.deform_conv import deform_conv2d, deform_conv2d_ref


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
        off = self.conv_offset(x)
        weight = self.weight.to(x.dtype)
        if torch.is_grad_enabled() and (x.requires_grad or off.requires_grad
                                        or weight.requires_grad):
            return deform_conv2d_ref(x, off, weight, self.groups, self.deform_groups)
        return deform_conv2d(x, off, weight, self.groups, self.deform_groups)


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
