"""CenterPoint's detection head: per-task heatmaps and dense regression maps (counterpart of robustpointclouds_tpu/nn/center_head.py).

mmdet3d's CenterHead as the reference's NuScenes config builds it: a shared
3x3 conv + BN + ReLU (512 -> 64), then per task a heatmap branch (its
classes) and the common regression branches reg (2), height (1), dim (3),
rot (2) and vel (2), each a SeparateHead: a 3x3 ConvModule (conv, BN,
ReLU) and a final 3x3 conv with bias (the heatmap's at -4.595, the focal
prior). With `use_dcn` (the `head-dcn` variant) a deformable feature
adaptation (DCN 3x3, groups 4, + BN + ReLU) runs in front of the heatmap
branch and another in front of the regression branches.

The head computes in float32 whatever the neck's type (the JAX head's flax
convs promote the bf16 neck output to their float32 parameters), and its
outputs are float32. BatchNorm follows flax's (momentum 0.9 = torch 0.1,
eps 1e-3, the biased variance into the running statistics:
nn/second.BatchNorm2d). Tensors are NCHW.

Module names follow mmdet3d's state_dict: `shared_conv.{conv,bn}`,
`task_heads.{t}.{heatmap,reg,height,dim,rot,vel}.{0.conv,0.bn,1}`; the DCN
variant's `task_heads.{t}.feature_adapt_{cls,reg}.{dcn,bn}`,
`task_heads.{t}.cls_head.{0.conv,0.bn,1}` and
`task_heads.{t}.task_head.{reg,...}` (DCNSeparateHead's layout).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from .deform_conv import DeformConv2d
from .second import BatchNorm2d

# NuScenes task grouping (mmdet3d centerpoint nus config)
NUSCENES_TASKS: Tuple[Tuple[str, ...], ...] = (
    ("car",),
    ("truck", "construction_vehicle"),
    ("bus", "trailer"),
    ("barrier",),
    ("motorcycle", "bicycle"),
    ("pedestrian", "traffic_cone"),
)

COMMON_HEADS: Tuple[Tuple[str, int], ...] = (
    ("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2)
)

HEATMAP_BIAS = -4.595


class ConvModule(nn.Module):
    """3x3 conv (no bias, padding 1) + BN + ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn = BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def separate_head(in_channels: int, out_channels: int, head_conv: int = 64) -> nn.Sequential:
    """mmdet3d SeparateHead branch of two convs: ConvModule (`0`), then a
    3x3 conv with bias (`1`)."""
    return nn.Sequential(ConvModule(in_channels, head_conv),
                         nn.Conv2d(head_conv, out_channels, 3, padding=1))


class _DCNAdapt(nn.Module):
    """Deformable feature adaptation: DCN 3x3 (groups 4) -> BN -> ReLU."""

    def __init__(self, channels: int = 64, groups: int = 4):
        super().__init__()
        self.dcn = DeformConv2d(channels, channels, groups=groups)
        self.bn = BatchNorm2d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.dcn(x)))


class CenterHead(nn.Module):
    """[B, Cin, H, W] neck output -> per task {'heatmap': [B, H, W, ncls],
    'reg': [B, H, W, 2], ...}, float32, channels last as the JAX head's."""

    def __init__(self, in_channels: int = 512,
                 tasks: Sequence[Sequence[str]] = NUSCENES_TASKS,
                 share_conv_channels: int = 64,
                 common_heads: Sequence[Tuple[str, int]] = COMMON_HEADS,
                 use_dcn: bool = False):
        super().__init__()
        self.use_dcn = use_dcn
        self.common_heads = tuple(common_heads)
        self.shared_conv = ConvModule(in_channels, share_conv_channels)
        c = share_conv_channels
        heads = []
        for classes in tasks:
            t = nn.Module()
            if use_dcn:
                t.feature_adapt_cls = _DCNAdapt(c)
                t.feature_adapt_reg = _DCNAdapt(c)
                t.cls_head = separate_head(c, len(classes))
                t.task_head = nn.ModuleDict({n: separate_head(c, d) for n, d in common_heads})
            else:
                t.heatmap = separate_head(c, len(classes))
                for n, d in common_heads:
                    t.add_module(n, separate_head(c, d))
            heads.append(t)
        self.task_heads = nn.ModuleList(heads)

    def forward(self, x: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], ...]:
        x = self.shared_conv(x.float())
        outs = []
        for t in self.task_heads:
            if self.use_dcn:
                heat, regs = t.cls_head(t.feature_adapt_cls(x)), t.feature_adapt_reg(x)
                branches = t.task_head
            else:
                heat, regs, branches = t.heatmap(x), x, t
            out = {"heatmap": heat}
            for name, _ in self.common_heads:
                out[name] = getattr(branches, name)(regs)
            outs.append({k: v.permute(0, 2, 3, 1) for k, v in out.items()})
        return tuple(outs)
