"""CenterPoint's CenterHead with the deformable feature adaptation, in
plain float32 torch: the reference of the configuration's head.

As mmdet3d's CenterHead with `DCNSeparateHead` (the published
`...head-dcn-circlenms` model): a shared 3x3 conv + BN + ReLU (in ->
share_conv_channels), then per task a deformable adaptation (DCN 3x3,
groups 4, + BN + ReLU) in front of the heatmap branch and another in front
of the regression branches (reg, height, dim, rot, vel), each branch a 3x3
conv + BN + ReLU and a final 3x3 conv with bias. Outputs are channels last,
[B, H, W, C], as the program's.

The deformable conv is mmcv's DeformConv2dPack (DCNv1): its offset conv
gives one (dy, dx) a tap, and each output reads its taps by bilinear
sampling at p + p_k + offset_k, a corner outside the map reading zero. Here
the sampling is `F.grid_sample` (bilinear, zeros padding, corners aligned),
which the program does not use; the product is a grouped einsum. It is a
subclass of nn.Conv2d with weight [out, in / groups, 3, 3] and no bias, so
that the benchmark's weights and FLOP counts treat it as the conv it is.

The whole head is stated in float32: every product's operands and output
go through `plain/precision.full` (bfloat16 in the control). BatchNorm is
flax's (the plain BatchNorm2d: the biased variance into the running
statistics, eps 1e-3). Module names are the program's (mmdet3d's state
dict): `shared_conv.{conv,bn}`, `task_heads.{t}.feature_adapt_{cls,reg}.
{dcn,bn}`, `task_heads.{t}.cls_head.{0.conv,0.bn,1}`,
`task_heads.{t}.task_head.{reg,...}.{0.conv,0.bn,1}`.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .plain import precision
from .plain.nn.second import BatchNorm2d


class Conv2d(nn.Conv2d):
    """A conv of a part stated in float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = precision.full(self.weight)
        return precision.full_out(F.conv2d(precision.full(x), w, self.bias, self.stride,
                                           self.padding, self.dilation, self.groups))


class DeformConv2d(nn.Conv2d):
    """mmcv's DeformConv2dPack(channels, channels, 3, padding=1, groups,
    deform_groups=1, bias=False)."""

    def __init__(self, channels: int, groups: int = 4, kernel: int = 3):
        super().__init__(channels, channels, kernel, padding=kernel // 2, groups=groups,
                         bias=False)
        self.conv_offset = Conv2d(channels, 2 * kernel * kernel, kernel, padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        k = self.kernel_size[0]
        taps = k * k
        off = self.conv_offset(x).reshape(b, taps, 2, h, w)  # (dy, dx) a tap
        r = torch.arange(k, device=x.device, dtype=torch.float32) - k // 2
        ty, tx = torch.meshgrid(r, r, indexing="ij")  # taps row-major
        ys = torch.arange(h, device=x.device, dtype=torch.float32)[None, None, :, None]
        xs = torch.arange(w, device=x.device, dtype=torch.float32)[None, None, None, :]
        py = ys + ty.reshape(1, taps, 1, 1) + off[:, :, 0]  # [B, K, H, W]
        px = xs + tx.reshape(1, taps, 1, 1) + off[:, :, 1]
        # grid_sample's corner-aligned coordinates: -1 the first cell, +1 the last
        grid = torch.stack([px / max(w - 1, 1) * 2 - 1, py / max(h - 1, 1) * 2 - 1], -1)
        grid = grid.permute(0, 2, 3, 1, 4).reshape(b, h, w * taps, 2)
        col = F.grid_sample(x.float(), grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True).reshape(b, c, h, w, taps)
        g = self.groups
        wt = precision.full(self.weight).reshape(g, c // g, c // g, taps)  # [g, o, i, k]
        col = precision.full(col).reshape(b, g, c // g, h, w, taps)
        out = torch.einsum("bgihwk,goik->bgohw", col, wt).reshape(b, c, h, w)
        return precision.full_out(out)


class ConvModule(nn.Module):
    """3x3 conv (no bias) + BN + ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def branch(cin: int, cout: int, head_conv: int) -> nn.Sequential:
    """A SeparateHead branch: ConvModule (`0`), then a 3x3 conv with bias (`1`)."""
    return nn.Sequential(ConvModule(cin, head_conv), Conv2d(head_conv, cout, 3, padding=1))


class FeatureAdapt(nn.Module):
    """DCN 3x3 (groups) -> BN -> ReLU."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.dcn = DeformConv2d(channels, groups)
        self.bn = BatchNorm2d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.dcn(x)))


class CenterHead(nn.Module):
    """[B, Cin, H, W] neck output -> per task {"heatmap": [B, H, W, C_t],
    "reg", "height", "dim", "rot", "vel": [B, H, W, d]}, float32."""

    def __init__(self, in_channels: int, tasks: Sequence[Sequence[str]], share_channels: int,
                 common_heads: Sequence[Tuple[str, int]], dcn_groups: int):
        super().__init__()
        self.common_heads = tuple((n, int(d)) for n, d in common_heads)
        self.shared_conv = ConvModule(in_channels, share_channels)
        c = share_channels
        heads = []
        for classes in tasks:
            t = nn.Module()
            t.feature_adapt_cls = FeatureAdapt(c, dcn_groups)
            t.feature_adapt_reg = FeatureAdapt(c, dcn_groups)
            t.cls_head = branch(c, len(classes), c)
            t.task_head = nn.ModuleDict({n: branch(c, d, c) for n, d in self.common_heads})
            heads.append(t)
        self.task_heads = nn.ModuleList(heads)

    def forward(self, x: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], ...]:
        x = self.shared_conv(x.float())
        outs = []
        for t in self.task_heads:
            out = {"heatmap": t.cls_head(t.feature_adapt_cls(x))}
            reg = t.feature_adapt_reg(x)
            for name, _ in self.common_heads:
                out[name] = t.task_head[name](reg)
            outs.append({k: v.permute(0, 2, 3, 1) for k, v in out.items()})
        return tuple(outs)
