"""SECOND BEV backbone + SECONDFPN neck (counterpart of robustpointclouds_tpu/nn/second.py).

Dense 2D convs run as torch conv ops (the JAX package leaves them to XLA).
Tensors are NCHW here; the compute dtype travels with the input tensor and
weights are cast to it at each call, while parameters and BN statistics stay
float32. Module names follow the mmdet3d state_dict (`blocks.s.j`,
`deblocks.i.j`): convs at 3*i, their BN at 3*i+1, ReLU at 3*i+2.

Padding follows the JAX package (flax 'SAME'): a stride-2 3x3 conv over an
even extent pads 0 before and 1 after, where mmdet3d pads 1 on both sides.
The stride-1 deblock is a 1x1 ConvTranspose2d, as mmdet3d builds it. The
JAX package's depth-to-space form of a stride-s deblock (`_DeconvD2S`,
RPC_FPN_D2S, off by default) sums the same products in another order; the
port keeps ConvTranspose2d, which tests/test_torch_fpn_d2s.py holds to
`_DeconvD2S` and which is the faster of the two on the H100 (chip_smoke.py
phase 16 (b)).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import precision


class SameConv2d(nn.Conv2d):
    """Conv2d without bias under flax 'SAME' padding, in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s in zip(x.shape[:1:-1], self.kernel_size[::-1], self.stride[::-1]):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return precision.body_out(F.conv2d(precision.body(F.pad(x, pads)),
                                           precision.body(self.weight), None, self.stride))


class ConvTranspose2d(nn.ConvTranspose2d):
    """Kernel == stride transposed conv without bias, in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return precision.body_out(F.conv_transpose2d(precision.body(x), precision.body(self.weight),
                                                     None, self.stride))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm computed in float32, output in the input's dtype.

    Train mode follows flax's nn.BatchNorm (the JAX backbone and neck): the
    batch mean and the *biased* variance normalise the batch and update the
    running stats (torch momentum 0.1 = flax momentum 0.9). torch's own
    training-mode batch_norm would update running_var with the unbiased
    variance, n/(n-1) larger.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-3, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var, self.weight,
                                self.bias, False, self.momentum, self.eps).to(x.dtype)
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * scale[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(x.dtype)


class SECONDBackbone(nn.Module):
    """Multi-stage 2D conv backbone over the BEV map; returns every stage's output."""

    def __init__(self, in_channels: int = 256, out_channels: Sequence[int] = (128, 256),
                 layer_nums: Sequence[int] = (5, 5), layer_strides: Sequence[int] = (1, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        blocks = []
        cin = in_channels
        for ch, n, s in zip(out_channels, layer_nums, layer_strides):
            layers = []
            for j in range(n + 1):
                layers += [SameConv2d(cin if j == 0 else ch, ch, 3, stride=s if j == 0 else 1,
                                      bias=False),
                           BatchNorm2d(ch), nn.ReLU()]
            blocks.append(nn.Sequential(*layers))
            cin = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = x.to(self.dtype)
        outs = []
        for block in self.blocks:
            x = block(x)
            outs.append(x)
        return tuple(outs)


class SECONDFPN(nn.Module):
    """Upsample each backbone stage to a common resolution and concat (NCHW)."""

    def __init__(self, in_channels: Sequence[int] = (128, 256),
                 out_channels: Sequence[int] = (256, 256),
                 upsample_strides: Sequence[int] = (1, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.deblocks = nn.ModuleList(
            nn.Sequential(ConvTranspose2d(cin, ch, s, stride=s, bias=False),
                          BatchNorm2d(ch), nn.ReLU())
            for cin, ch, s in zip(in_channels, out_channels, upsample_strides)
        )

    def forward(self, feats: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        return torch.cat([d(x.to(self.dtype)) for d, x in zip(self.deblocks, feats)], dim=1)
