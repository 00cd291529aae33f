"""The sparse middle encoder, plan-fed (counterpart of robustpointclouds_tpu/nn/sparse_encoder.py).

Two layouts of mmdet3d's SparseEncoder:
  * `conv_module` (SECOND): conv_input: subm k3 (in -> 16); stage 1: subm
    k3 (16); stages 2-4: a strided k3 s2 conv then two subm k3 convs (32,
    64, 64; the last stride has z-padding 0);
  * `basicblock` (CenterPoint): conv_input (5 -> 16), then per stage its
    residual SparseBasicBlocks (two subm convs, conv1-bn1-relu-conv2-bn2,
    plus the input, then ReLU) and the strided down as the stage's *last*
    element, the final stage without one: channels ((16, 16, 32), (32, 32,
    64), (64, 64, 128), (128, 128)), 21 sparse convs.
Both end with conv_out: strided k(3,1,1) s(2,1,1) (-> 128). Every conv is
the gather-GEMM kernel (kernels/sparse_conv.py) over a dense neighbour
index that ops/sparse.py derives from the host plan, followed by
MaskedBatchNorm, which fuses the ReLU and the row mask into its kernels
(a basic block's bn2 runs without them: the residual add comes first). A
dense scatter and a z-fold end the encoder. Each conv also gets its
backward index for the gather-only backward: a submanifold conv its own
forward index read with mirrored taps, a strided conv (the three downs and
conv_out) the plan's inverse `inv`. The two layouts read the same plan
levels (rel0-3, down1-3, out) in the same order.

Module names follow the mmdet3d state_dict (`conv_input`,
`encoder_layers.encoder_layerN.j`, `conv_out`, each a `0` conv + `1` BN
pair; a basic block's `conv1`/`bn1`/`conv2`/`bn2`) and the sparse weights
keep spconv2's (out, kz, ky, kx, in) layout, so tools/convert.py is the
inverse of the JAX package's zoo converter.

The inline index build (plan=None) is not ported.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..kernels.sparse_conv import sparse_conv_train
from ..ops import sparse
from .layers import MaskedBatchNorm

_SUBM_KX = 3
_OUT_GEOM = ((1, 3, 1, 1), (1, 2, 1, 1), (0, 0, 0, 0))  # conv_out (mmdet3d)


def _down_geom(num_stages: int, stage_i: int):
    """Static kernel/stride/padding of the stage-i strided downsample."""
    zpad = 0 if stage_i == num_stages - 1 else 1
    return (1, 3, 3, 3), (1, 2, 2, 2), (0, zpad, 1, 1)


def _down_shape(in_shape, kernel, stride, padding):
    return tuple(
        (dim + 2 * p - k) // s + 1
        for dim, k, s, p in zip(in_shape, kernel, stride, padding)
    )


class SparseConv3d(nn.Module):
    """Sparse conv weights in spconv2's (out, kz, ky, kx, in) layout."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3)):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, *kernel_size, in_channels))

    def img2col_kernel(self, dtype: torch.dtype) -> torch.Tensor:
        """[K*Cin, Cout] in the tap order of ops/sparse.kernel_offsets."""
        cout = self.weight.shape[0]
        return self.weight.permute(1, 2, 3, 4, 0).reshape(-1, cout).to(dtype).contiguous()

    def forward(self, feats: torch.Tensor, idx: torch.Tensor,
                bwd_idx: torch.Tensor, mirror: bool) -> torch.Tensor:
        """idx: forward index [M, K]; bwd_idx: the backward index (idx itself
        with `mirror=True` for a submanifold conv, the inverse index for a
        strided one). The weight's gradient stays float32."""
        return sparse_conv_train(feats.contiguous(), self.img2col_kernel(torch.float32),
                                 idx, bwd_idx, mirror)


class SparseConvBlock(nn.Sequential):
    """One sparse conv (`0`) + masked BN (`1`) + ReLU + row mask."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__(SparseConv3d(in_channels, out_channels, kernel_size),
                         MaskedBatchNorm(out_channels, dtype=dtype))
        self.dtype = dtype

    def forward(self, feats: torch.Tensor, out_mask: torch.Tensor, idx: torch.Tensor,
                inv: torch.Tensor = None) -> torch.Tensor:
        """Submanifold when `inv` is None, else strided with inverse index `inv`."""
        if inv is None:
            out = self[0](feats.to(self.dtype), idx, idx, True)
        else:
            out = self[0](feats.to(self.dtype), idx, inv, False)
        return self[1](out, out_mask, relu=True, row_mask=True)


class SparseBasicBlock(nn.Module):
    """Residual block over one grid: conv1-bn1-relu-conv2-bn2 (+x) relu, row
    mask (spconv/mmdet3d SparseBasicBlock). Submanifold convs keep the
    active set, so the residual add is row-wise."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = SparseConv3d(channels, channels)
        self.bn1 = MaskedBatchNorm(channels, dtype=dtype)
        self.conv2 = SparseConv3d(channels, channels)
        self.bn2 = MaskedBatchNorm(channels, dtype=dtype)
        self.dtype = dtype

    def forward(self, feats: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        identity = feats.to(self.dtype)
        x = self.bn1(self.conv1(identity, idx, idx, True), mask, relu=True, row_mask=True)
        x = self.bn2(self.conv2(x, idx, idx, True), mask)
        x = torch.relu(x + identity)
        return torch.where(mask[:, None], x, torch.zeros_like(x))


def relation_index(rel: Dict[str, torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    """A plan level's submanifold relation as the dense [N, 27] index."""
    if "rows" in rel:
        return sparse.xwin_to_index(rel["rows"], rel["xvalid"], ids, _SUBM_KX)
    return rel["idx"]


class SparseEncoder(nn.Module):
    """Sparse middle encoder: [N, Cin] voxel features -> BEV map [B, Dz*C, H/8, W/8]."""

    def __init__(self, sparse_shape: Tuple[int, int, int], in_channels: int = 4,
                 base_channels: int = 16,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16,), (32, 32, 32), (64, 64, 64), (64, 64, 64)),
                 out_channels: int = 128, dtype: torch.dtype = torch.float32,
                 block_type: str = "conv_module"):
        super().__init__()
        if block_type not in ("conv_module", "basicblock"):
            raise ValueError(f"unknown block_type {block_type!r}")
        self.encoder_channels = tuple(tuple(s) for s in encoder_channels)
        self.residual = block_type == "basicblock"
        n_stages = len(self.encoder_channels)
        shape = (1,) + tuple(sparse_shape)
        for i in range(1, n_stages):
            shape = _down_shape(shape, *_down_geom(n_stages, i))
        # channels of the BEV map: the z planes left after conv_out, folded
        self.bev_channels = _down_shape(shape, *_OUT_GEOM)[1] * out_channels
        self.conv_input = SparseConvBlock(in_channels, base_channels, dtype=dtype)
        layers = {}
        cin = base_channels
        for i, stage in enumerate(self.encoder_channels):
            blocks = []
            for j, ch in enumerate(stage):
                if self.residual and not (j == len(stage) - 1 and i != n_stages - 1):
                    blocks.append(SparseBasicBlock(ch, dtype=dtype))  # cin == ch
                else:
                    blocks.append(SparseConvBlock(cin, ch, dtype=dtype))
                cin = ch
            layers[f"encoder_layer{i + 1}"] = nn.ModuleList(blocks)
        self.encoder_layers = nn.ModuleDict(layers)
        self.conv_out = SparseConvBlock(cin, out_channels, kernel_size=(3, 1, 1), dtype=dtype)

    def forward(self, voxel_features: torch.Tensor, grid: sparse.SparseGrid,
                plan: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
        """voxel_features [N, Cin] aligned with `grid` (4D: batch, z, y, x);
        `plan` is the host plan's "enc" group, as tensors on the device.

        The BEV map's channel index is dz*C + c: the JAX z-fold's order
        (dz major), kept for parity.
        """
        n_stages = len(self.encoder_channels)
        shape = tuple(grid.spatial_shape)
        mask = grid.mask
        idx = relation_index(plan["rel0"], grid.flat_ids)
        x = self.conv_input(voxel_features, mask, idx)
        downs = 0
        for i in range(n_stages):
            for j, block in enumerate(self.encoder_layers[f"encoder_layer{i + 1}"]):
                # a strided down: first of stages 2-4 (conv_module), last of
                # stages 1-3 (basicblock); either way the plan's next level
                if self.residual:
                    is_down = not isinstance(block, SparseBasicBlock)
                else:
                    is_down = i != 0 and j == 0
                if is_down:
                    downs += 1
                    st = plan[f"down{downs}"]
                    down_idx = sparse.inverse_from_forward(st["inv"], st["ids"].shape[0])
                    x = block(x, st["mask"], down_idx, st["inv"])
                    shape = _down_shape(shape, *_down_geom(n_stages, downs))
                    mask = st["mask"]
                    idx = relation_index(plan[f"rel{downs}"], st["ids"])
                else:
                    x = block(x, mask, idx)

        st = plan["out"]
        x = self.conv_out(x, st["mask"], st["idx"], st["inv"])
        out_grid = sparse.SparseGrid(st["ids"], st["coords"], st["mask"],
                                     _down_shape(shape, *_OUT_GEOM))
        dense = sparse.scatter_to_dense(x, out_grid)  # [B, Dz, H', W', C]
        b, dz, h, w, c = dense.shape
        return dense.permute(0, 1, 4, 2, 3).reshape(b, dz * c, h, w)
