"""The residual (basicblock) sparse encoder of CenterPoint in plain float32
torch, built from the plain reference's SparseConv3d and MaskedBatchNorm.

mmdet3d's SparseEncoder with `block_type="basicblock"`: conv_input (in ->
base), then per stage its residual SparseBasicBlocks (two submanifold convs,
conv1-bn1-relu-conv2-bn2, plus the input, then ReLU and the row mask) and a
strided k3 s2 conv as the stage's last element, the final stage without
one; conv_out, strided k(3,1,1) s(2,1,1), ends it. At CenterPoint's
channels ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)) that is 21
sparse convs. It reads the plan's levels rel0-3, down1-3 and out, as the
conv_module layout does; a dense scatter and a z-fold (dz major) end it.
Module names are the program's: `conv_input.{0,1}`,
`encoder_layers.encoder_layerN.j.{conv1,bn1,conv2,bn2}` for a basic block,
`encoder_layers.encoder_layerN.j.{0,1}` for a strided conv, `conv_out.{0,1}`.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from .plain.nn.layers import MaskedBatchNorm
from .plain.nn.sparse_encoder import (_OUT_GEOM, SparseConv3d, SparseConvBlock, _down_geom,
                                      _down_shape, relation_index)
from .plain.ops import sparse


class SparseBasicBlock(nn.Module):
    """conv1-bn1-relu-conv2-bn2, + the input, ReLU, row mask, on one grid."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = SparseConv3d(channels, channels)
        self.bn1 = MaskedBatchNorm(channels)
        self.conv2 = SparseConv3d(channels, channels)
        self.bn2 = MaskedBatchNorm(channels)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        x = self.bn1(self.conv1(feats, idx, idx, True), mask, relu=True, row_mask=True)
        x = self.bn2(self.conv2(x, idx, idx, True), mask)
        x = torch.relu(x + feats)
        return torch.where(mask[:, None], x, torch.zeros_like(x))


class ResidualSparseEncoder(nn.Module):
    """[N, Cin] voxel features on the plan's grid -> BEV map [B, Dz*C, H/8, W/8]."""

    def __init__(self, sparse_shape: Tuple[int, int, int], in_channels: int,
                 base_channels: int, encoder_channels: Sequence[Sequence[int]],
                 out_channels: int):
        super().__init__()
        self.encoder_channels = tuple(tuple(s) for s in encoder_channels)
        n = len(self.encoder_channels)
        shape = (1,) + tuple(sparse_shape)
        for i in range(1, n):
            shape = _down_shape(shape, *_down_geom(n, i))
        self.bev_channels = _down_shape(shape, *_OUT_GEOM)[1] * out_channels
        self.conv_input = SparseConvBlock(in_channels, base_channels)
        layers = {}
        cin = base_channels
        for i, stage in enumerate(self.encoder_channels):
            blocks = []
            for j, ch in enumerate(stage):
                if j == len(stage) - 1 and i != n - 1:
                    blocks.append(SparseConvBlock(cin, ch))  # the stage's strided down
                else:
                    if ch != cin:
                        raise ValueError(f"a basic block keeps its width: {cin} -> {ch}")
                    blocks.append(SparseBasicBlock(ch))
                cin = ch
            layers[f"encoder_layer{i + 1}"] = nn.ModuleList(blocks)
        self.encoder_layers = nn.ModuleDict(layers)
        self.conv_out = SparseConvBlock(cin, out_channels, kernel_size=(3, 1, 1))

    def forward(self, feats: torch.Tensor, grid: sparse.SparseGrid,
                plan: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
        n = len(self.encoder_channels)
        shape = tuple(grid.spatial_shape)
        mask = grid.mask
        idx = relation_index(plan["rel0"], grid.flat_ids)
        x = self.conv_input(feats.float(), mask, idx)
        downs = 0
        for i in range(n):
            for block in self.encoder_layers[f"encoder_layer{i + 1}"]:
                if isinstance(block, SparseBasicBlock):
                    x = block(x, mask, idx)
                    continue
                downs += 1
                st = plan[f"down{downs}"]
                down_idx = sparse.inverse_from_forward(st["inv"], st["ids"].shape[0])
                x = block(x, st["mask"], down_idx, st["inv"])
                shape = _down_shape(shape, *_down_geom(n, downs))
                mask = st["mask"]
                idx = relation_index(plan[f"rel{downs}"], st["ids"])
        st = plan["out"]
        x = self.conv_out(x, st["mask"], st["idx"], st["inv"])
        out_grid = sparse.SparseGrid(st["ids"], st["coords"], st["mask"],
                                     _down_shape(shape, *_OUT_GEOM))
        dense = sparse.scatter_to_dense(x, out_grid)  # [B, Dz, H', W', C]
        b, dz, h, w, c = dense.shape
        return dense.permute(0, 1, 4, 2, 3).reshape(b, dz * c, h, w)
