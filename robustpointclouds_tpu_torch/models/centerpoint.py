"""AdversarialCenterPoint — the CenterPoint-on-NuScenes detector (counterpart of robustpointclouds_tpu/models/centerpoint.py).

Forward: plan (5-feature voxels: x, y, z, intensity, sweep lag, + every
sparse index; the native host plan, or with `plan=None` the torch plan
built on the points' device by `build_centerpoint_plan`) -> (learned
VoxelPerturber on the 5 features behind the gradient-reversal
`grad_scale`; the lag channel's bound is 0)
-> HardSimpleVFE -> the residual (basicblock) SparseEncoder, or with
`residual_encoder=False` the plain conv_module one at the same channels
(JAX's `model.residual_encoder=False`: 13 sparse convs instead of 21) ->
SECONDBackbone -> SECONDFPN -> CenterHead. The architecture is the reference's
centerpoint_voxel01_second_secfpn_head-dcn-circlenms base: voxels 0.1 x 0.1
x 0.2 over [-51.2, 51.2]^2 x [-5, 3], sparse shape [41, 1024, 1024], BEV
[B, 256, 128, 128] -> [B, 512, 128, 128] -> 6 tasks.

The adversary runs in training from `adversary_start_epoch` on (its
gradient reversal scaled by the epoch ramp -min(w * epoch / 10, w), applied
by the trainer) and always with `attack=True`. The JAX package wraps its
encoder in a rematerialisation (RPC_CP_REMAT), which does not change the
numerics; the port runs without it.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..core.registry import MODELS
from ..nn.center_head import NUSCENES_TASKS, CenterHead
from ..nn.perturber import VoxelPerturber
from ..nn.second import SECONDFPN, SECONDBackbone
from ..nn.sparse_encoder import SparseEncoder
from ..nn.vfe import HardSimpleVFE
from ..ops.sparse import SparseGrid
from ..ops.voxelize import VoxelizerConfig
from .center_detection import CenterHeadConfig, centerpoint_targets
from .voxelnet import _ADV_AUX_KEYS, apply_voxel_adversary, inline_inputs, sparse_plan_core

NUSCENES_CLASSES = tuple(c for task in NUSCENES_TASKS for c in task)


class CenterPointConfig(NamedTuple):
    voxelizer: VoxelizerConfig = VoxelizerConfig(
        point_cloud_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
        voxel_size=(0.1, 0.1, 0.2),
        max_points_per_voxel=10,
        max_voxels=60000,
    )
    num_point_features: int = 5  # x, y, z, intensity, timestamp
    # the zoo CenterPoint's basicblock SparseEncoder
    encoder_channels: Tuple[Tuple[int, ...], ...] = (
        (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)
    )
    # False: the plain conv_module layout at encoder_channels (conv_input,
    # each stage's strided down first from stage 2 on, submanifold convs
    # otherwise, conv_out: 13 sparse convs), as JAX's residual=False
    residual_encoder: bool = True
    tasks: Tuple[Tuple[str, ...], ...] = NUSCENES_TASKS
    head: CenterHeadConfig = CenterHeadConfig(tasks=NUSCENES_TASKS)
    adversary: Optional[Dict[str, Any]] = {
        "sensor_error_bound": 0.2,
        "use_spatial_attention": True,
        "hidden_channels": (16, 32, 64),
    }
    adversarial_loss_weight: float = 0.05
    regularization_weight: float = 0.005
    adversary_start_epoch: int = 3
    # compute dtype of the encoder/backbone/neck ("bfloat16"|"float32"); the
    # head, parameters, BN statistics and the adversary's bounds stay f32
    compute_dtype: str = "bfloat16"
    # the DCN separate head of the reference's base config (plain conv default)
    use_dcn_head: bool = False

    @property
    def bev_feature_size(self) -> Tuple[int, int]:
        nx, ny, _ = self.voxelizer.grid_size
        return (ny // 8, nx // 8)


class CenterPointOutputs(NamedTuple):
    task_preds: Tuple[Dict[str, torch.Tensor], ...]
    adv_aux: Dict[str, torch.Tensor]


@MODELS.register_module()
@MODELS.register_module(name="CenterPoint")
class AdversarialCenterPoint(nn.Module):
    """CenterPoint with an optional pre-encoder voxel adversary; module names
    are mmdet3d's (`pts_middle_encoder`, `pts_backbone`, `pts_neck`,
    `pts_bbox_head`)."""

    def __init__(self, cfg: CenterPointConfig = CenterPointConfig()):
        super().__init__()
        self.cfg = cfg
        dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.pts_middle_encoder = SparseEncoder(
            cfg.voxelizer.sparse_shape, in_channels=cfg.num_point_features,
            encoder_channels=cfg.encoder_channels, dtype=dt,
            block_type="basicblock" if cfg.residual_encoder else "conv_module")
        self.pts_backbone = SECONDBackbone(self.pts_middle_encoder.bev_channels, dtype=dt)
        self.pts_neck = SECONDFPN(dtype=dt)
        self.pts_bbox_head = CenterHead(tasks=cfg.tasks, use_dcn=cfg.use_dcn_head)
        if cfg.adversary is not None:
            self.adversary = VoxelPerturber(
                num_features=cfg.num_point_features,
                **{k: tuple(v) if isinstance(v, (list, tuple)) else v
                   for k, v in cfg.adversary.items()})
        else:
            self.adversary = None

    def forward(self, points: Optional[torch.Tensor], points_mask: Optional[torch.Tensor],
                train: bool, epoch: float = 0, attack: bool = False,
                adv_grad_scale: float = -1.0, plan: Dict[str, Any] = None) -> CenterPointOutputs:
        """Forward, as AdversarialVoxelNet's: `plan` the host plan
        (train/centerpoint_loop.CenterPointPlanBuilder) on the device
        (`plan_to_device`; points and points_mask are then not read and may
        be None), or None: built inline from points [B, P, 5] on their
        device by `build_centerpoint_plan`. `train` sets the
        module's mode; `attack=True` applies the adversary with its
        evaluation-attack bounds; `adv_grad_scale` scales the perturbation
        delta's gradient."""
        if plan is None:
            points, points_mask = inline_inputs(points, points_mask, self)
            plan = build_centerpoint_plan(points, points_mask, self.cfg)
        if train != self.training:
            self.train(train)
        voxels = plan["voxels"]
        point_mask = plan["point_mask"]
        b = voxels.shape[0]
        grid = SparseGrid(plan["grid_ids"], plan["grid_coords"], plan["grid_mask"],
                          (b,) + tuple(self.cfg.voxelizer.sparse_shape))
        zero = voxels.new_zeros(())
        adv_aux = {k: zero for k in _ADV_AUX_KEYS}
        if self.adversary is not None and (train or attack):
            voxels, adv_aux = apply_voxel_adversary(
                self.adversary, voxels, point_mask, attack, epoch,
                self.cfg.adversary_start_epoch, adv_grad_scale)
        feats = HardSimpleVFE(voxels, point_mask)
        feats = feats.reshape(-1, feats.shape[-1])[plan["order"].long()]
        bev = self.pts_middle_encoder(feats, grid, plan["enc"])
        fused = self.pts_neck(self.pts_backbone(bev))
        return CenterPointOutputs(self.pts_bbox_head(fused), adv_aux)


def build_centerpoint_plan(points: torch.Tensor, points_mask: torch.Tensor,
                           cfg: CenterPointConfig, gt_boxes=None, gt_labels=None, gt_mask=None,
                           gt_vel=None) -> Dict[str, Any]:
    """The plan of AdversarialCenterPoint, built in torch ops on the points'
    device: `sparse_plan_core` over the 5-feature points and, given GTs,
    the CenterHead's targets under "targets" (center_detection.centerpoint_targets)
    on that device. Bit-equal to the host plan
    (train/centerpoint_loop.CenterPointPlanBuilder); JAX's jitted builder
    keeps down2's forward relation dense where both keep it in x-window
    form (the same index, tests/test_torch_inline_plan.py)."""
    plan = sparse_plan_core(points, points_mask, cfg.voxelizer, cfg.num_point_features)
    if gt_boxes is not None:
        plan["targets"] = centerpoint_targets(
            *(torch.as_tensor(x, device=points.device)
              for x in (gt_boxes, gt_labels, gt_mask, gt_vel)),
            cfg.bev_feature_size, cfg.head)
    return plan


def centerpoint_adversary_terms(det_losses: Dict[str, torch.Tensor],
                                adv_aux: Dict[str, torch.Tensor], epoch: float,
                                adversarial_loss_weight: float = 0.05,
                                regularization_weight: float = 0.005):
    """(adversary-only loss term, gradient-reversal scale, logs) of the
    CenterPoint objective (reference adversarial_centerpoint.py:160-171):
    -min(w * epoch / 10, w) * clipped det total, carried by the reversal
    scale on the perturbation delta, plus reg_weight * l2."""
    w = adversarial_loss_weight
    ramp = min(w * float(epoch) / 10.0, w)
    l2 = adv_aux["l2_norm"]
    loss_reg = regularization_weight * l2
    det_total = l2.new_zeros(())
    for k, v in det_losses.items():
        if k.startswith("loss"):
            det_total = det_total + torch.clamp(torch.nan_to_num(v), 0.0, 100.0)
    det_total = torch.clamp(det_total, 0.0, 500.0)
    logs = {"loss_adversarial": -(ramp * det_total).detach(),
            "loss_l2_regularization": loss_reg,
            "perturbation_l2_norm": l2.detach()}
    return loss_reg, -ramp, logs
