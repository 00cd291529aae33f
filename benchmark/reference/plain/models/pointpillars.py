"""AdversarialPointPillars — the all-dense pillar family (counterpart of robustpointclouds_tpu/models/pointpillars.py).

Forward: pillar plan (voxels on a single-z grid of 0.16 m pillars, the
merged (batch, y, x) BEV grid) -> (learned VoxelPerturber on the raw pillar
points behind the gradient-reversal `grad_scale`) -> PillarFeatureNet (9
decorated features -> Linear -> MaskedBatchNorm + ReLU -> masked max over
the pillar) -> BEV scatter -> SECONDBackbone -> SECONDFPN -> Anchor3DHead.
No sparse convolution. The plan is built here from the points, in plain
torch; the program's CUDA graph of it, its `dense` cell map and the host
plan are left out.

Geometry follows mmdet3d's pointpillars_hv_secfpn_8xb6-160e_kitti-3d-3class:
0.16 m pillars over [0, -39.68, -3, 69.12, 39.68, 1], 32 points a pillar,
16000 pillars, backbone (64, 128, 256) x (3, 5, 5) at strides (2, 2, 2),
FPN upsample (1, 2, 4) -> 384 channels at stride 2 (BEV 248 x 216). Module
names follow mmdet3d (`voxel_encoder.pfn_layers.0.linear` / `.norm`,
`backbone`, `neck`, `bbox_head`), so one state dict serves this model and
the port's.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import precision
from ..nn.anchor_head import Anchor3DHead
from ..nn.layers import MaskedBatchNorm
from ..nn.perturber import VoxelPerturber
from ..nn.second import SECONDFPN, SECONDBackbone
from ..ops import anchors as anchor_ops
from ..ops.sparse import SparseGrid, scatter_to_dense, with_batch_axis
from ..ops.voxelize import VoxelizerConfig, voxelize_batch
from .detection import AnchorHeadConfig
from .voxelnet import _ADV_AUX_KEYS, ModelOutputs, apply_voxel_adversary, inline_inputs


class PointPillarsConfig(NamedTuple):
    """Static config; VoxelNetConfig's surface plus the pillar body's widths."""

    voxelizer: VoxelizerConfig = VoxelizerConfig(
        point_cloud_range=(0.0, -39.68, -3.0, 69.12, 39.68, 1.0),
        voxel_size=(0.16, 0.16, 4.0),
        max_points_per_voxel=32,
        max_voxels=16000,
    )
    num_classes: int = 3
    class_names: Sequence[str] = ("Car", "Pedestrian", "Cyclist")
    anchor_ranges: Sequence[Sequence[float]] = (
        (0, -39.68, -1.78, 69.12, 39.68, -1.78),
        (0, -39.68, -0.6, 69.12, 39.68, -0.6),
        (0, -39.68, -0.6, 69.12, 39.68, -0.6),
    )
    anchor_sizes: Sequence[Sequence[float]] = (
        (3.9, 1.6, 1.56),
        (0.8, 0.6, 1.73),
        (1.76, 0.6, 1.73),
    )
    anchor_rotations: Sequence[float] = (0.0, 1.5707963)
    head: AnchorHeadConfig = AnchorHeadConfig()
    pfn_channels: int = 64
    backbone_channels: Sequence[int] = (64, 128, 256)
    backbone_layers: Sequence[int] = (3, 5, 5)
    backbone_strides: Sequence[int] = (2, 2, 2)
    fpn_channels: Sequence[int] = (128, 128, 128)
    fpn_strides: Sequence[int] = (1, 2, 4)
    adversary: Optional[Dict[str, Any]] = {
        "sensor_error_bound": 0.2,
        "use_spatial_attention": True,
        "hidden_channels": (64, 128, 64),
    }
    adversarial_loss_weight: float = 0.1
    regularization_weight: float = 0.02
    adversary_start_epoch: int = 3
    compute_dtype: str = "float32"

    @property
    def bev_feature_size(self) -> Tuple[int, int]:
        nx, ny, _ = self.voxelizer.grid_size
        s = self.backbone_strides[0]
        return (ny // s, nx // s)

    def make_anchors(self) -> Tuple[np.ndarray, np.ndarray]:
        a = anchor_ops.generate_anchors(
            self.bev_feature_size, self.anchor_ranges, self.anchor_sizes,
            self.anchor_rotations,
        )
        cls_ids = anchor_ops.anchor_class_ids(
            self.bev_feature_size, len(self.anchor_sizes), len(self.anchor_rotations)
        )
        return anchor_ops.flatten_anchors(a), cls_ids


class PFNLayer(nn.Module):
    """mmdet3d's PFNLayer without its max: a bias-free Linear (a product of
    the part the configuration states in its compute dtype), then
    MaskedBatchNorm (momentum 0.01, eps 1e-3) and ReLU over the valid slots."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels, bias=False)
        self.norm = MaskedBatchNorm(out_channels, momentum=0.01, eps=1e-3)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = precision.body_out(F.linear(precision.body(feats), precision.body(self.linear.weight)))
        return self.norm(x, mask, relu=True)


class PillarFeatureNet(nn.Module):
    """9 decorated features a point slot (x, y, z, r, the offsets from the
    pillar's point mean, the x and y offsets from the pillar's centre) ->
    PFNLayer -> masked max over the pillar."""

    def __init__(self, out_channels: int, voxel_size: Tuple[float, float],
                 pc_start: Tuple[float, float]):
        super().__init__()
        self.out_channels = out_channels
        self.voxel_size = voxel_size
        self.pc_start = pc_start
        self.pfn_layers = nn.ModuleList([PFNLayer(9, out_channels)])

    def forward(self, voxels: torch.Tensor, point_mask: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        """voxels [B, V, T, 4], point_mask [B, V, T], coords [B, V, 3]
        (z, y, x) -> [B, V, C], 0 for empty pillars."""
        b, v, t, _ = voxels.shape
        m = point_mask[..., None].float()
        cnt = torch.clamp(m.sum(2), min=1.0)
        mean_xyz = (voxels[..., :3] * m).sum(2) / cnt
        f_cluster = voxels[..., :3] - mean_xyz[:, :, None, :]
        cx = (coords[..., 2].float() + 0.5) * self.voxel_size[0] + self.pc_start[0]
        cy = (coords[..., 1].float() + 0.5) * self.voxel_size[1] + self.pc_start[1]
        f_center = torch.stack([voxels[..., 0] - cx[:, :, None], voxels[..., 1] - cy[:, :, None]],
                               dim=-1)
        feats = torch.cat([voxels, f_cluster, f_center], dim=-1) * m
        x = self.pfn_layers[0](feats.reshape(b * v * t, 9), point_mask.reshape(b * v * t))
        x = x.reshape(b, v, t, self.out_channels)
        x = torch.where(point_mask[..., None], x, torch.full_like(x, -1e9)).amax(2)
        return torch.where(point_mask.any(2)[..., None], x, torch.zeros_like(x))


def build_pillar_plan(points: torch.Tensor, points_mask: torch.Tensor,
                      vz: VoxelizerConfig) -> Dict[str, Any]:
    """The voxels of the 4 point features and the merged (batch, y, x) BEV
    grid with its `order`, on the points' device."""
    res = voxelize_batch(points[..., :4].float(), points_mask.bool(), vz)
    nx, ny, _ = vz.grid_size
    grid, order = with_batch_axis(res.coords[..., 1:], res.voxel_mask, (ny, nx))
    return {"voxels": res.voxels, "vox_coords": res.coords, "point_mask": res.point_mask,
            "order": order, "grid_ids": grid.flat_ids, "grid_coords": grid.coords,
            "grid_mask": grid.mask}


class AdversarialPointPillars(nn.Module):
    """PointPillars with the pre-encoder voxel adversary of AdversarialVoxelNet."""

    def __init__(self, cfg: PointPillarsConfig = PointPillarsConfig()):
        super().__init__()
        self.cfg = cfg
        vx, vy, _ = cfg.voxelizer.voxel_size
        pcr = cfg.voxelizer.point_cloud_range
        self.voxel_encoder = PillarFeatureNet(cfg.pfn_channels, (vx, vy), (pcr[0], pcr[1]))
        self.backbone = SECONDBackbone(cfg.pfn_channels, tuple(cfg.backbone_channels),
                                       tuple(cfg.backbone_layers), tuple(cfg.backbone_strides))
        self.neck = SECONDFPN(tuple(cfg.backbone_channels), tuple(cfg.fpn_channels),
                              tuple(cfg.fpn_strides))
        self.bbox_head = Anchor3DHead(
            in_channels=sum(cfg.fpn_channels), num_classes=cfg.num_classes,
            num_anchors_per_loc=len(cfg.anchor_sizes) * len(cfg.anchor_rotations))
        if cfg.adversary is not None:
            self.adversary = VoxelPerturber(
                num_features=4, **{k: tuple(v) if isinstance(v, (list, tuple)) else v
                                   for k, v in cfg.adversary.items()})
        else:
            self.adversary = None

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor, train: bool,
                epoch: float = 0, attack: bool = False, adv_grad_scale: float = -1.0,
                plan: Dict[str, Any] = None) -> ModelOutputs:
        """AdversarialVoxelNet's contract: `train` sets the module's mode,
        `attack=True` applies the adversary at its evaluation bounds,
        `adv_grad_scale` is the gradient reversal on its delta."""
        if plan is None:
            points, points_mask = inline_inputs(points, points_mask, self)
            plan = build_pillar_plan(points, points_mask, self.cfg.voxelizer)
        if train != self.training:
            self.train(train)
        voxels = plan["voxels"]
        point_mask = plan["point_mask"]
        zero = voxels.new_zeros(())
        adv_aux = {k: zero for k in _ADV_AUX_KEYS}
        if self.adversary is not None and (train or attack):
            voxels, adv_aux = apply_voxel_adversary(
                self.adversary, points, voxels, plan, attack, epoch,
                self.cfg.adversary_start_epoch, adv_grad_scale)
        feats = self.voxel_encoder(voxels, point_mask, plan["vox_coords"])
        nx, ny, _ = self.cfg.voxelizer.grid_size
        grid = SparseGrid(plan["grid_ids"], plan["grid_coords"], plan["grid_mask"],
                          (voxels.shape[0], ny, nx))
        rows = feats.reshape(-1, feats.shape[-1])[plan["order"].long()]
        bev = scatter_to_dense(rows, grid)  # [B, ny, nx, C]
        fused = self.neck(self.backbone(bev.permute(0, 3, 1, 2).contiguous()))
        return ModelOutputs(*self.bbox_head(fused), adv_aux)
