"""Anchor3DHead: the 1x1 conv predictors (counterpart of robustpointclouds_tpu/nn/anchor_head.py)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import precision


class Anchor3DHead(nn.Module):
    def __init__(self, in_channels: int = 512, num_classes: int = 3,
                 num_anchors_per_loc: int = 6, box_code_size: int = 7,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = num_anchors_per_loc
        self.box_code_size = box_code_size
        self.dtype = dtype
        self.conv_cls = nn.Conv2d(in_channels, num_anchors_per_loc * num_classes, 1)
        self.conv_reg = nn.Conv2d(in_channels, num_anchors_per_loc * box_code_size, 1)
        self.conv_dir_cls = nn.Conv2d(in_channels, num_anchors_per_loc * 2, 1)

    def _pred(self, conv: nn.Conv2d, x: torch.Tensor, width: int) -> torch.Tensor:
        out = precision.body_out(F.conv2d(precision.body(x), precision.body(conv.weight), conv.bias))
        b, _, h, w = out.shape
        return out.permute(0, 2, 3, 1).reshape(b, h, w, self.num_anchors, width).float()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [B, C, H, W] -> cls [B, H, W, A, classes], bbox [B, H, W, A, 7],
        dir [B, H, W, A, 2], float32 in the JAX layout."""
        x = x.to(self.dtype)
        return (self._pred(self.conv_cls, x, self.num_classes),
                self._pred(self.conv_reg, x, self.box_code_size),
                self._pred(self.conv_dir_cls, x, 2))
