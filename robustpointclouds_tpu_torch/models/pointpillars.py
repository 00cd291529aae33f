"""AdversarialPointPillars — the all-dense pillar family (counterpart of robustpointclouds_tpu/models/pointpillars.py).

Forward: pillar plan (data/native_plan.build_pillar_plan_native on the
host, or `build_pillar_plan` in torch ops on the points' device when
`plan=None`, on the card one replay of a CUDA graph a shape: voxels on a
single-z grid, the merged (batch, y, x) BEV grid)
-> (learned VoxelPerturber on the raw pillar points behind the gradient-reversal
`grad_scale`) -> PillarFeatureNet (9 decorated features -> Linear ->
MaskedBatchNorm + ReLU -> masked max over the pillar) -> BEV scatter
(ops/sparse.scatter_to_dense, as SECOND's encoder output; JAX's plan-fed
forward gathers through the plan's cell -> row map `dense` instead, equal
bit for bit and slower on the H100, ops/sparse.py says more) ->
SECONDBackbone -> SECONDFPN -> Anchor3DHead. No sparse convolution: the
pillar network is dense 2D work apart from K2 under the PFN's BatchNorm and
the adversary.

Geometry follows mmdet3d's pointpillars_hv_secfpn_8xb6-160e_kitti-3d-3class:
0.16 m pillars over [0, -39.68, -3, 69.12, 39.68, 1], 32 points a pillar,
16000 pillars, backbone (64, 128, 256) x (3, 5, 5) at strides (2, 2, 2),
FPN upsample (1, 2, 4) -> 384 channels at stride 2 (BEV 248 x 216). Module
names follow mmdet3d (`voxel_encoder.pfn_layers.0.linear` / `.norm`,
`backbone`, `neck`, `bbox_head`). The model keeps AdversarialVoxelNet's
call contract, so train/loop.Trainer, run_training, run_evaluation, the
attacks and export_serving take it as they take SECOND.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.registry import MODELS
from ..core.spans import span
from ..nn.anchor_head import Anchor3DHead
from ..nn.layers import MaskedBatchNorm
from ..nn.perturber import VoxelPerturber
from ..nn.second import SECONDFPN, SECONDBackbone
from ..ops import anchors as anchor_ops
from ..ops import sparse
from ..ops.sparse import SparseGrid, scatter_to_dense, with_batch_axis
from ..ops.voxelize import VoxelizerConfig, voxelize_batch
from .detection import AnchorHeadConfig
from .voxelnet import (_ADV_AUX_KEYS, ModelOutputs, adversary_reads_points, apply_voxel_adversary,
                       graphed_plan, inline_inputs)


class PointPillarsConfig(NamedTuple):
    """Static config; VoxelNetConfig's surface, so the trainer, the drivers
    and the CLIs take it unchanged."""

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
    compute_dtype: str = "bfloat16"

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
    """mmdet3d's PFNLayer without its max: a bias-free Linear in the compute
    dtype, then MaskedBatchNorm (flax momentum 0.99 = torch 0.01, eps 1e-3)
    fused with the ReLU over the valid point slots."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(in_channels, out_channels, bias=False)
        self.norm = MaskedBatchNorm(out_channels, dtype=dtype, momentum=0.01, eps=1e-3)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = F.linear(feats.to(self.dtype), self.linear.weight.to(self.dtype))
        return self.norm(x, mask, relu=True)


class PillarFeatureNet(nn.Module):
    """mmdet3d PillarFeatureNet (num_filters [64], with_distance False):
    9-feature decorated points -> PFNLayer -> masked max over the pillar."""

    def __init__(self, out_channels: int = 64, voxel_size: Tuple[float, float] = (0.16, 0.16),
                 pc_start: Tuple[float, float] = (0.0, -39.68),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_channels = out_channels
        self.voxel_size = voxel_size
        self.pc_start = pc_start
        self.pfn_layers = nn.ModuleList([PFNLayer(9, out_channels, dtype)])

    def forward(self, voxels: torch.Tensor, point_mask: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        """voxels [B, V, T, 4], point_mask [B, V, T], coords [B, V, 3] (z, y, x)
        -> [B, V, C] in the compute dtype, 0 for empty pillars."""
        b, v, t, _ = voxels.shape
        m = point_mask[..., None].to(voxels.dtype)
        cnt = torch.clamp(m.sum(2), min=1.0)  # [B, V, 1]
        mean_xyz = (voxels[..., :3] * m).sum(2) / cnt
        f_cluster = voxels[..., :3] - mean_xyz[:, :, None, :]
        # pillar centre offsets: x from coords[..., 2], y from coords[..., 1]
        cx = (coords[..., 2].to(voxels.dtype) + 0.5) * self.voxel_size[0] + self.pc_start[0]
        cy = (coords[..., 1].to(voxels.dtype) + 0.5) * self.voxel_size[1] + self.pc_start[1]
        f_center = torch.stack([voxels[..., 0] - cx[:, :, None], voxels[..., 1] - cy[:, :, None]],
                               dim=-1)
        feats = torch.cat([voxels, f_cluster, f_center], dim=-1) * m  # padding rows zeroed
        x = self.pfn_layers[0](feats.reshape(b * v * t, 9), point_mask.reshape(b * v * t))
        x = x.reshape(b, v, t, self.out_channels)
        # the masked max; amax splits a tie's gradient evenly, as JAX's max does
        x = torch.where(point_mask[..., None], x, torch.full((), -1e9, dtype=x.dtype,
                                                             device=x.device)).amax(2)
        return torch.where(point_mask.any(2)[..., None], x, torch.zeros((), dtype=x.dtype,
                                                                         device=x.device))


def build_pillar_plan(points: torch.Tensor, points_mask: torch.Tensor,
                      cfg: PointPillarsConfig) -> Dict[str, Any]:
    """The plan of AdversarialPointPillars over the 4 point features, built
    on the points' device (`pillar_plan_eager`; on the card one replay of a
    CUDA graph a shape, models/voxelnet.graphed_plan under the builder
    "pillar")."""
    return graphed_plan("pillar", pillar_plan_eager, points, points_mask, cfg.voxelizer, 4)


def pillar_plan_eager(points: torch.Tensor, points_mask: torch.Tensor, vz: VoxelizerConfig,
                      num_features: int = 4) -> Dict[str, Any]:
    """The pillar plan in torch ops on the points' device: the voxels, the
    merged (batch, y, x) BEV grid with its `order`, and `dense`, the grid
    row of each of the B * ny * nx BEV cells (B * V when empty), bit for
    bit as JAX's `build_pillar_plan` and the native host plan
    (data/native_plan.build_pillar_plan_native) hold them."""
    res = voxelize_batch(points[..., :num_features].float(), points_mask.bool(), vz)
    nx, ny, _ = vz.grid_size
    grid, order = with_batch_axis(res.coords[..., 1:], res.voxel_mask, (ny, nx))
    n = grid.flat_ids.shape[0]
    size = res.voxels.shape[0] * ny * nx
    cell = torch.where(grid.mask, torch.clamp(grid.flat_ids, max=size),
                       torch.full_like(grid.flat_ids, size))
    dense = sparse.scatter_set(size, cell, torch.arange(n, dtype=torch.int32, device=cell.device), n)
    return {"voxels": res.voxels, "vox_coords": res.coords, "num_points": res.num_points,
            "voxel_mask": res.voxel_mask, "point_mask": res.point_mask,
            "slot_point": res.slot_point, "point_slot": res.point_slot, "order": order,
            "grid_ids": grid.flat_ids, "grid_coords": grid.coords, "grid_mask": grid.mask,
            "dense": dense}


@MODELS.register_module()
@MODELS.register_module(name="PointPillars")
class AdversarialPointPillars(nn.Module):
    """PointPillars with the pre-encoder voxel adversary of AdversarialVoxelNet."""

    reads_points = property(adversary_reads_points)

    def __init__(self, cfg: PointPillarsConfig = PointPillarsConfig()):
        super().__init__()
        self.cfg = cfg
        dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        vx, vy, _ = cfg.voxelizer.voxel_size
        pcr = cfg.voxelizer.point_cloud_range
        self.voxel_encoder = PillarFeatureNet(cfg.pfn_channels, (vx, vy), (pcr[0], pcr[1]),
                                              dtype=dt)
        self.backbone = SECONDBackbone(cfg.pfn_channels, tuple(cfg.backbone_channels),
                                       tuple(cfg.backbone_layers), tuple(cfg.backbone_strides),
                                       dtype=dt)
        self.neck = SECONDFPN(tuple(cfg.backbone_channels), tuple(cfg.fpn_channels),
                              tuple(cfg.fpn_strides), dtype=dt)
        self.bbox_head = Anchor3DHead(
            in_channels=sum(cfg.fpn_channels), num_classes=cfg.num_classes,
            num_anchors_per_loc=len(cfg.anchor_sizes) * len(cfg.anchor_rotations), dtype=dt)
        if cfg.adversary is not None:
            self.adversary = VoxelPerturber(
                num_features=4, **{k: tuple(v) if isinstance(v, (list, tuple)) else v
                                   for k, v in cfg.adversary.items()})
        else:
            self.adversary = None

    def forward(self, points: Optional[torch.Tensor], points_mask: Optional[torch.Tensor],
                train: bool, epoch: float = 0, attack: bool = False,
                adv_grad_scale: float = -1.0, plan: Dict[str, Any] = None) -> ModelOutputs:
        """AdversarialVoxelNet's contract on a pillar plan (the host's,
        data/native_plan.build_pillar_plan_native, on the device; points and
        points_mask may then be None; only the compact adversary reads the
        points), or with plan=None on the plan `build_pillar_plan` builds
        from the points on their device."""
        with span("rpc.plan"):
            if plan is None:
                points, points_mask = inline_inputs(points, points_mask, self)
                plan = build_pillar_plan(points, points_mask, self.cfg)
            if train != self.training:
                self.train(train)
        voxels = plan["voxels"]
        point_mask = plan["point_mask"]
        zero = voxels.new_zeros(())
        adv_aux = {k: zero for k in _ADV_AUX_KEYS}
        if self.adversary is not None and (train or attack):
            with span("rpc.adversary"):
                voxels, adv_aux = apply_voxel_adversary(
                    self.adversary, points, voxels, plan, attack, epoch,
                    self.cfg.adversary_start_epoch, adv_grad_scale)
        with span("rpc.encoder"):
            feats = self.voxel_encoder(voxels, point_mask, plan["vox_coords"])  # [B, V, C]
            nx, ny, _ = self.cfg.voxelizer.grid_size
            b = voxels.shape[0]
            grid = SparseGrid(plan["grid_ids"], plan["grid_coords"], plan["grid_mask"],
                              (b, ny, nx))
            rows = feats.reshape(-1, feats.shape[-1])[plan["order"].long()]
            bev = scatter_to_dense(rows, grid)  # [B, ny, nx, C]
        with span("rpc.dense"):
            fused = self.neck(self.backbone(bev.permute(0, 3, 1, 2).contiguous()))
            cls_scores, bbox_preds, dir_preds = self.bbox_head(fused)
        return ModelOutputs(cls_scores, bbox_preds, dir_preds, adv_aux)
