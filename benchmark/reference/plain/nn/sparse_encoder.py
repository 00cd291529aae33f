"""The sparse middle encoder, plan-fed (counterpart of robustpointclouds_tpu/nn/sparse_encoder.py).

mmdet3d's SparseEncoder in its `conv_module` layout (SECOND): conv_input:
subm k3 (in -> 16); stage 1: subm k3 (16); stages 2-4: a strided k3 s2 conv
then two subm k3 convs (32, 64, 64; the last stride has z-padding 0); then
conv_out: strided k(3,1,1) s(2,1,1) (-> 128). Every conv is
the gather-GEMM kernel (kernels/sparse_conv.py) over a dense neighbour
index that ops/sparse.py derives from the host plan, followed by
MaskedBatchNorm, which fuses the ReLU and the row mask into its kernels. A
dense scatter and a z-fold end the encoder. Each conv also gets its
backward index for the gather-only backward: a submanifold conv its own
forward index read with mirrored taps, a strided conv (the three downs and
conv_out) the plan's inverse `inv`. It reads the plan levels rel0-3,
down1-3 and out in that order.

Module names follow the mmdet3d state_dict (`conv_input`,
`encoder_layers.encoder_layerN.j`, `conv_out`, each a `0` conv + `1` BN
pair) and the sparse weights
keep spconv2's (out, kz, ky, kx, in) layout, so tools/convert.py is the
inverse of the JAX package's zoo converter.

`encoder_plan` builds the "enc" group of the plan in torch ops on the
grid's device: the inline (plan=None) path's index build.
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
_SUBM_KERNEL = (1, 3, 3, 3)  # batch axis has extent 1
_N_STAGES = 4  # the plan's grid levels 0-3 (rel0-3, down1-3), then out
# the relations the native plan keeps in x-window form; the others as the
# dense index (its layout is fixed, whatever the encoder's widths)
_XWIN_LEVELS = ("rel0", "rel1", "down1", "down2")


def _down_geom(num_stages: int, stage_i: int):
    """Static kernel/stride/padding of the stage-i strided downsample."""
    zpad = 0 if stage_i == num_stages - 1 else 1
    return (1, 3, 3, 3), (1, 2, 2, 2), (0, zpad, 1, 1)


def _down_shape(in_shape, kernel, stride, padding):
    return tuple(
        (dim + 2 * p - k) // s + 1
        for dim, k, s, p in zip(in_shape, kernel, stride, padding)
    )


def encoder_plan(grid: sparse.SparseGrid, n_cap: int) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every neighbour and downsample index of the encoder, on the grid's
    device: the "enc" group of the plan, key for key and bit for bit the
    native host plan's (data/native_plan.py).

    rel0..rel3 are the submanifold relations of the four grid levels,
    down1..down3 the strided downsamples' output grids ({ids, coords, mask}),
    inverse index `inv` and forward relation, `out` conv_out's grid with
    `idx` and `inv`. The relations of _XWIN_LEVELS are kept in x-window
    form ({rows, xvalid}), the others as the dense `idx`. `n_cap` = B *
    max_voxels sets the levels' row caps (native_plan.level_caps).
    """
    def subm_rel(name: str, g: sparse.SparseGrid):
        if name in _XWIN_LEVELS:
            xw = sparse.neighbor_xwin_info(g, g.coords, g.mask, _SUBM_KERNEL, (1, 1, 1, 1),
                                           (0, 1, 1, 1))
            return {"rows": xw.rows, "xvalid": xw.xvalid}
        return {"idx": sparse.neighbor_index(g, g.coords, g.mask, _SUBM_KERNEL, (1, 1, 1, 1),
                                             (0, 1, 1, 1))}

    caps = level_caps(n_cap)
    g = grid
    plan = {"rel0": subm_rel("rel0", g)}
    for i in range(1, _N_STAGES):
        k4, s4, p4 = _down_geom(_N_STAGES, i)
        name = f"down{i}"
        xwin = name in _XWIN_LEVELS
        new_g, down_idx, down_inv = sparse.downsample_with_index(g, k4, s4, p4, caps[i - 1],
                                                                 forward=not xwin)
        st = {"ids": new_g.flat_ids, "coords": new_g.coords, "mask": new_g.mask,
              "inv": down_inv}
        if xwin:
            dense_idx = sparse.inverse_from_forward(down_inv, new_g.flat_ids.shape[0])
            xw = sparse.xwin_from_index(dense_idx, new_g.coords, new_g.mask, k4[-1],
                                        g.flat_ids.shape[0], s4[-1], p4[-1],
                                        g.spatial_shape[-1])
            st["rows"], st["xvalid"] = xw.rows, xw.xvalid
        else:
            st["idx"] = down_idx
        plan[name] = st
        g = new_g
        plan[f"rel{i}"] = subm_rel(f"rel{i}", g)

    k4, s4, p4 = _OUT_GEOM
    out_g, out_idx, out_inv = sparse.downsample_with_index(g, k4, s4, p4, caps[-1])
    plan["out"] = {"ids": out_g.flat_ids, "coords": out_g.coords, "mask": out_g.mask,
                   "idx": out_idx, "inv": out_inv}
    return plan


_STAGE_FACTORS = (1.0, 1.0, 0.75, 0.5)
_OUT_FACTOR = 0.5


def level_caps(n: int) -> Tuple[int, int, int, int]:
    """Row caps of down1, down2, down3 and conv_out's grid over `n` = B *
    max_voxels merged rows."""
    return tuple(max(int(n * f), 1) for f in _STAGE_FACTORS[1:] + (_OUT_FACTOR,))


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
        if block_type != "conv_module":
            raise ValueError(f"the reference keeps the conv_module layout, not {block_type!r}")
        self.encoder_channels = tuple(tuple(s) for s in encoder_channels)
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
            for ch in stage:
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
                # a strided down, the first of stages 2-4: the plan's next level
                if i != 0 and j == 0:
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
