"""AdversarialVoxelNet — the SECOND-on-KITTI detector (counterpart of robustpointclouds_tpu/models/voxelnet.py).

Forward: plan (voxels + every sparse index) -> (learned VoxelPerturber
behind the gradient-reversal `grad_scale`) -> HardSimpleVFE ->
SparseEncoder -> SECONDBackbone -> SECONDFPN -> Anchor3DHead. The plan is
the host's (data/native_plan.build_plan_native, moved to the device) or,
with `plan=None`, built inline by `build_plan` in torch ops on the points'
device (ops/voxelize.py, ops/sparse.py, nn/sparse_encoder.encoder_plan;
on the card one replay of a CUDA graph a shape, `sparse_plan_core`);
the two are bit-equal, so the forwards are too. The adversary runs in
training from `adversary_start_epoch` on, and always with `attack=True`
(the evaluation-under-attack mode).

Training helpers: `anchor_assign_plan` (the host plan's anchor assignment,
CPU torch in the prefetch thread) and `adversary_direct_terms` (the
adversary's own loss terms, added to the single train scalar).
"""
from __future__ import annotations

import functools
import math
import os
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core import graphs
from ..core.registry import MODELS
from ..core.spans import span
from ..nn.anchor_head import Anchor3DHead
from ..nn.deform_conv import DeformConv2d
from ..nn.perturber import VoxelPerturber
from ..nn.second import SECONDFPN, SECONDBackbone
from ..nn.sparse_encoder import SparseConv3d, SparseEncoder, encoder_plan
from ..nn.vfe import HardSimpleVFE
from ..ops import anchors as anchor_ops
from ..ops.grad import grad_scale
from ..ops import sparse
from ..ops.sparse import SparseGrid, with_batch_axis
from ..ops.voxelize import VoxelizerConfig, voxelize_batch
from ..ops import assigner
from .detection import AnchorHeadConfig


class VoxelNetConfig(NamedTuple):
    """Static architecture config; defaults mirror the reference 3-class config
    (configs/adversarial/adversarial-second_hv_secfpn_8xb6-80e_kitti-3d-3class.py)."""

    voxelizer: VoxelizerConfig = VoxelizerConfig(
        point_cloud_range=(0.0, -40.0, -3.0, 70.4, 40.0, 1.0),
        voxel_size=(0.05, 0.05, 0.1),
        max_points_per_voxel=5,
        max_voxels=16000,
    )
    num_classes: int = 3
    class_names: Sequence[str] = ("Car", "Pedestrian", "Cyclist")
    anchor_ranges: Sequence[Sequence[float]] = (
        (0, -40.0, -0.6, 70.4, 40.0, -0.6),
        (0, -40.0, -0.6, 70.4, 40.0, -0.6),
        (0, -40.0, -0.6, 70.4, 40.0, -0.6),
    )
    anchor_sizes: Sequence[Sequence[float]] = (
        (3.9, 1.6, 1.56),
        (0.8, 0.6, 1.73),
        (1.76, 0.6, 1.73),
    )
    anchor_rotations: Sequence[float] = (0.0, 1.5707963)
    head: AnchorHeadConfig = AnchorHeadConfig()
    # adversary (None disables — plain VoxelNet)
    adversary: Optional[Dict[str, Any]] = {
        "sensor_error_bound": 0.2,
        "use_spatial_attention": True,
        "hidden_channels": (64, 128, 64),
    }
    adversarial_loss_weight: float = 0.1
    regularization_weight: float = 0.02
    adversary_start_epoch: int = 3
    # compute dtype of the encoder/backbone/neck/head ("bfloat16"|"float32");
    # parameters, BN statistics, box decoding and the adversary's bounds stay f32
    compute_dtype: str = "bfloat16"

    @property
    def bev_feature_size(self) -> Tuple[int, int]:
        nx, ny, _ = self.voxelizer.grid_size
        return (ny // 8, nx // 8)

    def make_anchors(self) -> Tuple[np.ndarray, np.ndarray]:
        a = anchor_ops.generate_anchors(
            self.bev_feature_size, self.anchor_ranges, self.anchor_sizes,
            self.anchor_rotations,
        )
        cls_ids = anchor_ops.anchor_class_ids(
            self.bev_feature_size, len(self.anchor_sizes), len(self.anchor_rotations)
        )
        return anchor_ops.flatten_anchors(a), cls_ids


class ModelOutputs(NamedTuple):
    cls_scores: torch.Tensor   # [B, H, W, A, C]
    bbox_preds: torch.Tensor   # [B, H, W, A, 7]
    dir_preds: torch.Tensor    # [B, H, W, A, 2]
    adv_aux: Dict[str, torch.Tensor]  # perturbation loss terms (zeros if no adversary)


# Run the voxel adversary over the compact point list instead of the padded
# voxel slots (RPC_COMPACT_PERT, off by default, as in the JAX package):
# B*P rows instead of B*V*T, the same numbers up to float32 reduction order.
COMPACT_PERT = os.environ.get("RPC_COMPACT_PERT", "0") == "1"

def adversary_reads_points(model: nn.Module) -> bool:
    """Whether a plan-fed forward of a voxel-adversary model reads the
    points beside its plan: the compact adversary (COMPACT_PERT) runs over
    them. Each such model exposes it as its `reads_points` property."""
    return COMPACT_PERT and model.adversary is not None


_ADV_AUX_KEYS = ("l2_norm", "l2_percentage", "intensity_loss", "bias_loss",
                 "imbalance_loss", "max_perturbation", "mean_perturbation",
                 "std_perturbation")


def apply_voxel_adversary(adversary: VoxelPerturber, points: Optional[torch.Tensor],
                          voxels: torch.Tensor, plan: Dict[str, Any], attack: bool,
                          epoch: float, start_epoch: int, adv_grad_scale: float):
    """Pre-encoder raw-voxel perturbation, shared by SECOND, CenterPoint and
    PointPillars (the strong family perturbs its post-VFE voxel rows
    instead, so COMPACT_PERT does not reach it).

    Reference semantics (adversarial_voxelnet.py:135-146): perturb the padded
    voxel features before the VFE, gated until epoch >= start (attack mode
    bypasses the gate), deltas through gradient reversal. By default the
    adversary runs over the padded slots [B*V*T, F] with the plan's
    `point_mask`. With COMPACT_PERT (RPC_COMPACT_PERT=1) it runs over the
    compact point list points[..., :F] as [B*P, F], masked by the points
    that survived voxelisation (`point_slot` < V*T), and the bounded deltas
    are gathered into the slots through `slot_point` (a zero row for empty
    slots): the surviving points are in bijection with the valid slots, so
    the masked statistics see the same multiset of rows and the result is
    the padded form's up to float32 reduction order. Every surviving point
    owns one slot, so the gather's backward is a gather back through
    `point_slot` (ops/sparse.bijective_gather), no scatter-add.
    The compact form needs the points [B, P, >=F] the plan was built from
    (a model's `reads_points` says so to its caller) and raises without
    them. Returns (voxels, gate-scaled aux loss dict).
    """
    b, v, t, f = voxels.shape
    gate = 1.0 if (attack or epoch >= start_epoch) else 0.0
    if COMPACT_PERT:
        slot_point, point_slot = plan.get("slot_point"), plan.get("point_slot")
        if points is None or slot_point is None or point_slot is None:
            raise ValueError("RPC_COMPACT_PERT: the compact adversary needs the points the "
                             "plan was built from and the plan's slot_point / point_slot")
        points = torch.as_tensor(points, dtype=torch.float32, device=voxels.device)
        p_cnt = points.shape[1]
        pts = points[..., :f].reshape(b * p_cnt, f)
        survived = (point_slot < v * t).reshape(b * p_cnt)
        perturbed, aux = adversary(pts, survived, attack)
        delta_pts = grad_scale(perturbed - pts, adv_grad_scale)
        # slot -> point row (B*P: an empty slot) and point -> slot row
        # (B*V*T: a dropped point), each offset by its frame
        sp = slot_point.reshape(b, v * t).long()
        ps = point_slot.long()
        gidx = torch.where(sp < p_cnt, sp + torch.arange(b, device=sp.device)[:, None] * p_cnt,
                           torch.full_like(sp, b * p_cnt))
        pidx = torch.where(ps < v * t, ps + torch.arange(b, device=ps.device)[:, None] * (v * t),
                           torch.full_like(ps, b * v * t))
        delta = sparse.bijective_gather(delta_pts.contiguous(), gidx.reshape(-1),
                                        pidx.reshape(-1)).reshape(b, v, t, f)
        return voxels + gate * delta, {k: gate * val for k, val in aux.items()}
    flat = voxels.reshape(b * v * t, f)
    perturbed, aux = adversary(flat, plan["point_mask"].reshape(b * v * t), attack)
    delta = grad_scale(perturbed.reshape(b, v, t, f) - voxels, adv_grad_scale)
    return voxels + gate * delta, {k: gate * val for k, val in aux.items()}


@MODELS.register_module()
@MODELS.register_module(name="VoxelNet")
class AdversarialVoxelNet(nn.Module):
    """SECOND detector with an optional pre-encoder voxel adversary."""

    reads_points = property(adversary_reads_points)

    def __init__(self, cfg: VoxelNetConfig = VoxelNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.sparse_shape = tuple(cfg.voxelizer.sparse_shape)
        self.voxelizer = cfg.voxelizer
        dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.middle_encoder = SparseEncoder(cfg.voxelizer.sparse_shape, dtype=dt)
        self.backbone = SECONDBackbone(self.middle_encoder.bev_channels, dtype=dt)
        self.neck = SECONDFPN(dtype=dt)
        self.bbox_head = Anchor3DHead(
            num_classes=cfg.num_classes,
            num_anchors_per_loc=len(cfg.anchor_sizes) * len(cfg.anchor_rotations),
            dtype=dt,
        )
        if cfg.adversary is not None:
            self.adversary = VoxelPerturber(
                num_features=4, **{k: tuple(v) if isinstance(v, (list, tuple)) else v
                                   for k, v in cfg.adversary.items()})
        else:
            self.adversary = None

    def forward(self, points: Optional[torch.Tensor], points_mask: Optional[torch.Tensor],
                train: bool, epoch: float = 0, attack: bool = False,
                adv_grad_scale: float = -1.0, plan: Dict[str, Any] = None) -> ModelOutputs:
        """Forward on `plan`: the host plan of data/native_plan.build_plan_native
        on the device (`plan_to_device`), whose voxels stand for the points
        (points/points_mask may be None; only the compact adversary,
        COMPACT_PERT, reads the points), or None: the
        inline path builds it from points [B, P, >=4] / points_mask [B, P]
        on the points' device (`build_plan`).

        `train` sets the module's mode (BatchNorm batch statistics and the
        adversary's epoch gate), as the JAX forward's argument does.
        `attack=True` applies the adversary with the aggressive eval-bound
        profile regardless of `train`; `adv_grad_scale` is the gradient
        reversal factor on the perturbation delta.
        """
        with span("rpc.plan"):
            if plan is None:
                points, points_mask = inline_inputs(points, points_mask, self)
                plan = build_plan(points, points_mask, self.voxelizer)
            grid = self._grid(plan, train)
        voxels = plan["voxels"]
        zero = voxels.new_zeros(())
        adv_aux = {k: zero for k in _ADV_AUX_KEYS}
        if self.adversary is not None and (train or attack):
            with span("rpc.adversary"):
                voxels, adv_aux = apply_voxel_adversary(
                    self.adversary, points, voxels, plan, attack, epoch,
                    self.cfg.adversary_start_epoch, adv_grad_scale,
                )
        with span("rpc.encoder"):
            bev = self.middle_encoder(self._vfe(voxels, plan), grid, plan["enc"])
        with span("rpc.dense"):
            heads = self.bbox_head(self.neck(self.backbone(bev)))
        return ModelOutputs(*heads, adv_aux)

    def _plan(self, points, points_mask, plan: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        """`plan`, or the inline plan of the points, built on their device."""
        if plan is not None:
            return plan
        points, points_mask = inline_inputs(points, points_mask, self)
        return build_plan(points, points_mask, self.voxelizer)

    def _grid(self, plan: Dict[str, Any], train: bool) -> SparseGrid:
        """Sets the module's mode and returns the plan's sparse grid."""
        if train != self.training:
            self.train(train)
        return SparseGrid(plan["grid_ids"], plan["grid_coords"], plan["grid_mask"],
                          (plan["voxels"].shape[0],) + self.sparse_shape)

    def _vfe(self, voxels: torch.Tensor, plan: Dict[str, Any]) -> torch.Tensor:
        """HardSimpleVFE's [B*V, F] features in the plan's `order`."""
        feats = HardSimpleVFE(voxels, plan["point_mask"])
        return feats.reshape(-1, feats.shape[-1])[plan["order"].long()]

    def _detect(self, feats: torch.Tensor, grid: SparseGrid, plan: Dict[str, Any]):
        """SparseEncoder -> backbone -> FPN -> Anchor3DHead: (cls, bbox, dir)."""
        bev = self.middle_encoder(feats, grid, plan["enc"])
        return self.bbox_head(self.neck(self.backbone(bev)))


def inline_inputs(points, points_mask, module: nn.Module):
    """Points and mask as tensors for the inline path: tensors stay on their
    device, arrays go to the module's."""
    if points is None or points_mask is None:
        raise ValueError("plan=None (the inline path) needs points and points_mask")
    dev = next(module.parameters()).device
    if not isinstance(points, torch.Tensor):
        points = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    if not isinstance(points_mask, torch.Tensor):
        points_mask = torch.as_tensor(np.asarray(points_mask, bool), device=points.device)
    return points, points_mask.bool()


# the inline plan's CUDA graphs, one a (device, shape, features, voxelizer)
PLAN_GRAPHS = graphs.GraphCache(capacity=4)
PLAN_GRAPH_CALLS = PLAN_GRAPHS.calls  # "capture" / "replay" / "eager" -> calls


def plan_graph_key(points: torch.Tensor, points_mask: torch.Tensor, vz: VoxelizerConfig,
                   num_features: int) -> tuple:
    """What the plan's graph depends on, for `points` as the plan reads them
    (`[..., :num_features]` in float32, whatever the caller's dtype)."""
    return points.device, tuple(points.shape), num_features, tuple(points_mask.shape), vz


def sparse_plan_core(points: torch.Tensor, points_mask: torch.Tensor, vz: VoxelizerConfig,
                     num_features: int) -> Dict[str, Any]:
    """`sparse_plan_eager`'s plan. On the card it is one replay of a CUDA
    graph captured on the first call of each input signature
    (core/graphs.py; `PLAN_GRAPH_CALLS` counts captures and replays), with
    fresh output tensors each call; on the CPU, under torch.compile or
    torch.export, inside another capture, or where autograd records
    through the points, the eager body runs (counted "eager")."""
    pts, mask = points[..., :num_features].float(), points_mask.bool()
    if not graphs.replayable(pts, mask):
        PLAN_GRAPH_CALLS["eager"] += 1
        return sparse_plan_eager(pts, mask, vz, num_features)
    return PLAN_GRAPHS(plan_graph_key(pts, mask, vz, num_features),
                       functools.partial(sparse_plan_eager, vz=vz, num_features=num_features),
                       (pts, mask))


def sparse_plan_eager(points: torch.Tensor, points_mask: torch.Tensor, vz: VoxelizerConfig,
                      num_features: int) -> Dict[str, Any]:
    """Voxelise + batch merge + the encoder's index plan, in torch ops on the
    points' device: the dict of build_plan_native, key for key and bit for
    bit (int32 ids and indices, bool masks, float32 voxels). The model
    families add their own groups on top."""
    res = voxelize_batch(points[..., :num_features].float(), points_mask.bool(), vz)
    grid, order = with_batch_axis(res.coords, res.voxel_mask, vz.sparse_shape)
    b, v = res.voxels.shape[:2]
    return {"voxels": res.voxels, "vox_coords": res.coords, "num_points": res.num_points,
            "voxel_mask": res.voxel_mask, "point_mask": res.point_mask,
            "slot_point": res.slot_point, "point_slot": res.point_slot, "order": order,
            "grid_ids": grid.flat_ids, "grid_coords": grid.coords, "grid_mask": grid.mask,
            "enc": encoder_plan(grid, b * v)}


def build_plan(points: torch.Tensor, points_mask: torch.Tensor, cfg, gt_boxes=None,
               gt_labels=None, gt_mask=None,
               anchors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Dict[str, Any]:
    """The SECOND plan of a batch, built in torch ops on the points' device
    (`sparse_plan_core` on 4 features): the inline path's counterpart of
    the host plan (data/native_plan.build_plan_native + anchor_assign_plan)
    and of JAX's `build_plan`, bit for bit. With GTs, the anchor assignment
    "assign" on that device (ops/assigner.assign); `cfg` a VoxelNetConfig,
    or a VoxelizerConfig when no GTs are given. `anchors`: (anchors,
    classes) from cfg.make_anchors() on the points' device, to skip
    rebuilding them per call.
    """
    vz = cfg if isinstance(cfg, VoxelizerConfig) else cfg.voxelizer
    plan = sparse_plan_core(points, points_mask, vz, 4)
    if gt_boxes is not None:
        dev = points.device
        if anchors is None:
            a, c = cfg.make_anchors()
            anchors = (torch.as_tensor(a, device=dev), torch.as_tensor(c, device=dev))
        head = cfg.head
        res = assigner.assign(anchors[0], anchors[1],
                              torch.as_tensor(gt_boxes, dtype=torch.float32, device=dev),
                              torch.as_tensor(gt_labels, device=dev).to(torch.int32),
                              torch.as_tensor(gt_mask, device=dev).bool(),
                              head.pos_iou_thr, head.neg_iou_thr, head.min_pos_iou)
        plan["assign"] = {"labels": res.labels, "matched_gt": res.matched_gt,
                          "pos_mask": res.pos_mask, "neg_mask": res.neg_mask}
    return plan


def plan_to_device(plan: Any, device: torch.device) -> Any:
    """The host plan (nested dicts and lists of numpy arrays or tensors) as
    tensors on `device`."""
    if isinstance(plan, dict):
        return {k: plan_to_device(v, device) for k, v in plan.items()}
    if isinstance(plan, (list, tuple)):
        return [plan_to_device(v, device) for v in plan]
    if not isinstance(plan, torch.Tensor):
        plan = torch.from_numpy(np.ascontiguousarray(plan))
    return plan.to(device)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random initialisation from `generator`, following the JAX package's
    flax initialisers: fan-in normal for convs (sparse, deformable, dense)
    and linears, the focal prior bias -4.595 on the class logits and
    heatmaps, zero DCN offset convs, N(0, 0.025) on the adversary's output
    layer, identity BatchNorm. Serves AdversarialVoxelNet and
    AdversarialCenterPoint."""
    def normal_(t: torch.Tensor, std: float):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=generator) * std)

    offsets = {id(m.conv_offset) for m in model.modules() if isinstance(m, DeformConv2d)}
    for name, mod in model.named_modules():
        if isinstance(mod, (SparseConv3d, DeformConv2d)):
            fan_in = mod.weight[0].numel() * getattr(mod, "groups", 1)
            normal_(mod.weight, math.sqrt(1.0 / fan_in))
        elif isinstance(mod, nn.ConvTranspose2d):
            w = mod.weight  # (in, out, kh, kw): flax fans in over in * kh * kw
            normal_(w, math.sqrt(1.0 / (w.shape[0] * w.shape[2] * w.shape[3])))
        elif id(mod) in offsets:
            with torch.no_grad():
                mod.weight.zero_()
                mod.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            std = 0.025 if name.endswith("mlp_out") else math.sqrt(1.0 / mod.weight[0].numel())
            normal_(mod.weight, std)
            if mod.bias is not None:
                if name.endswith("mlp_out"):
                    normal_(mod.bias, 0.025)
                else:
                    prior = name.endswith(("conv_cls", "heatmap.1", "cls_head.1"))
                    with torch.no_grad():
                        mod.bias.fill_(-4.595 if prior else 0.0)
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.reset_parameters()


def anchor_assign_plan(gt_boxes, gt_labels, gt_mask, cfg: VoxelNetConfig,
                       anchors: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> Dict[str, np.ndarray]:
    """Batched anchor Max-IoU assignment as a plan group (numpy arrays [B, A]).

    Parameter-free (static anchors vs GT boxes), so the O(A*G) IoU matrix runs
    on the host, in CPU torch, beside the native plan build; the device keeps
    only the elementwise target encoding. `anchors`: (anchors, classes) CPU
    tensors from cfg.make_anchors(), to skip rebuilding them per call.
    """
    if anchors is None:
        a, c = cfg.make_anchors()
        anchors = (torch.from_numpy(a), torch.from_numpy(c))
    head = cfg.head
    res = assigner.assign(anchors[0], anchors[1], torch.as_tensor(np.asarray(gt_boxes, np.float32)),
                          torch.as_tensor(np.asarray(gt_labels, np.int32)),
                          torch.as_tensor(np.asarray(gt_mask, bool)),
                          head.pos_iou_thr, head.neg_iou_thr, head.min_pos_iou)
    return {"labels": res.labels.numpy(), "matched_gt": res.matched_gt.numpy(),
            "pos_mask": res.pos_mask.numpy(), "neg_mask": res.neg_mask.numpy()}


def adversary_direct_terms(det_losses: Dict[str, torch.Tensor], adv_aux: Dict[str, torch.Tensor],
                           epoch: float, regularization_weight: float = 0.02):
    """Adversary-only loss terms, added to the single train scalar (with the
    gradient reversal on the perturbation delta this is the reference's
    adversary objective, adversarial_voxelnet.py:203-413):

      -10*(l2 - 0.05) + 1.01*(3*intensity + 10*bias + 10*imbalance)
      + reg_weight * reg_scale(epoch) * weak(l2) * l2

    reg_scale = max(0.1, 1 - (epoch+1)/30); weak = 0.01/0.1/0.3/1 for l2 below
    0.001/0.005/0.01/above (on the detached l2). Returns (total, logs); the
    logs clamp the reference's way but never enter the gradient.
    """
    l2 = adv_aux["l2_norm"]
    l2_magnitude = -10.0 * (l2 - 0.05)
    aux_terms = (3.0 * adv_aux["intensity_loss"] + 10.0 * adv_aux["bias_loss"]
                 + 10.0 * adv_aux["imbalance_loss"])
    reg_scale = max(0.1, 1.0 - (float(epoch) + 1.0) / 30.0)
    l2s = l2.detach()
    weak = torch.where(l2s < 0.001, 0.01, torch.where(l2s < 0.005, 0.1,
                                                      torch.where(l2s < 0.01, 0.3, 1.0)))
    loss_reg = regularization_weight * reg_scale * weak * l2
    total = l2_magnitude + 1.01 * aux_terms + loss_reg

    det_total = l2.new_zeros(())
    for k, v in det_losses.items():
        if k.startswith("loss"):
            det_total = det_total + torch.clamp(torch.nan_to_num(v), 0.0, 100.0)
    det_total = torch.clamp(det_total, 0.0, 500.0)
    zero = l2.new_zeros(())
    logs = {
        "loss_adversarial": torch.clamp(-det_total + l2_magnitude.detach(), -10.0, 10.0),
        "loss_intensity": 3.0 * adv_aux["intensity_loss"],
        "loss_bias": 10.0 * adv_aux["bias_loss"],
        "loss_imbalance": 10.0 * adv_aux["imbalance_loss"],
        "loss_l2_regularization": loss_reg,
        "perturbation_l2_norm": l2s,
        "l2_percentage": adv_aux.get("l2_percentage", zero).detach(),
        "max_perturbation": adv_aux.get("max_perturbation", zero).detach(),
        "mean_perturbation": adv_aux.get("mean_perturbation", zero).detach(),
        "std_perturbation": adv_aux.get("std_perturbation", zero).detach(),
    }
    return total, logs
