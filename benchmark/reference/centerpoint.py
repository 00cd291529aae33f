"""The CenterPoint family in the plain reference: the model of a
configuration file in float32 (TF32 off where the harness runs it), its
train loss, its evaluation head outputs and their decode.

The model is mmdet3d's published CenterPoint with the DCN head
(`centerpoint_voxel01_second_secfpn_head-dcn-circlenms`) behind the repo's
learned voxel adversary, as the program runs it: the plan built from the
points (the plain voxelizer and sparse index plan), the adversary on the
padded voxel slots behind its gradient reversal (its objective the
epoch-ramped -min(w * epoch / 10, w) on the perturbation delta, plus the
L2 regulariser), HardSimpleVFE, the residual sparse encoder
(residual_encoder.py), the SECOND backbone and FPN, the CenterHead
(center_head.py); targets, losses and decode in center_detection.py, whose
docstring lists the departures from the published description. Parameter
and buffer names are the program's, so one state dict serves both.

The configuration's "head", "train_cfg" and "test_cfg" groups follow
mmdet3d's: `head_fields` gathers them into the flat settings the targets,
losses and decode read (the names of the program's CenterHeadConfig).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from . import center_detection as cd
from .center_head import CenterHead
from .plain.models.voxelnet import (apply_voxel_adversary, inline_inputs,
                                    sparse_plan_core)
from .plain.nn.perturber import VoxelPerturber
from .plain.nn.second import SECONDFPN, SECONDBackbone
from .plain.nn.vfe import HardSimpleVFE
from .plain.ops.sparse import SparseGrid
from .plain.ops.voxelize import VoxelizerConfig
from .residual_encoder import ResidualSparseEncoder


def voxelizer_config(m: Dict, cls=VoxelizerConfig):
    vz = m["voxelizer"]
    return cls(tuple(vz["point_cloud_range"]), tuple(vz["voxel_size"]),
               int(vz["max_points_per_voxel"]), int(vz["max_voxels"]))


def tasks(m: Dict) -> Tuple[Tuple[str, ...], ...]:
    return tuple(tuple(t) for t in m["head"]["tasks"])


def head_fields(m: Dict) -> Dict:
    """The settings of targets, losses and decode, under the program's
    CenterHeadConfig names."""
    vz, hd, tr, te = m["voxelizer"], m["head"], m["train_cfg"], m["test_cfg"]
    if te["nms_type"] != "circle":
        raise ValueError(f"the reference decodes with circle NMS, not {te['nms_type']!r}")
    return {"point_cloud_range": tuple(vz["point_cloud_range"]),
            "voxel_size": tuple(vz["voxel_size"][:2]),
            "out_factor": int(tr["out_size_factor"]), "max_objs": int(tr["max_objs"]),
            "gaussian_overlap": float(tr["gaussian_overlap"]),
            "min_radius": int(tr["min_radius"]),
            "heatmap_weight": float(hd["heatmap_weight"]),
            "bbox_weight": float(hd["bbox_weight"]),
            "code_weights": tuple(float(c) for c in tr["code_weights"]),
            "score_thr": float(te["score_threshold"]), "nms_pre": int(te["max_num"]),
            "max_per_task": int(te["post_max_size"]),
            "circle_radius": tuple(float(r) for r in te["min_radius"])}


def bev_size(m: Dict) -> Tuple[int, int]:
    nx, ny, _ = voxelizer_config(m).grid_size
    f = int(m["train_cfg"]["out_size_factor"])
    return ny // f, nx // f


def flatten(preds: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The tasks' outputs as {"task<t>.<branch>": tensor}."""
    return {f"task{t}.{k}": v for t, p in enumerate(preds) for k, v in p.items()}


def unflatten(heads: Dict[str, torch.Tensor], n_tasks: int):
    out = [{} for _ in range(n_tasks)]
    for key, v in heads.items():
        t, branch = key.split(".", 1)
        out[int(t[4:])][branch] = v
    return out


class AdversarialCenterPoint(nn.Module):
    """CenterPoint with the voxel adversary, from a configuration's "model" group."""

    def __init__(self, m: Dict):
        super().__init__()
        self.vz = voxelizer_config(m)
        self.num_features = int(m["num_point_features"])
        self.start_epoch = int(m["adversary_start_epoch"])
        if tuple(m["sparse_shape"]) != self.vz.sparse_shape:
            raise ValueError(f"sparse_shape {m['sparse_shape']} is not the voxelizer's "
                             f"{self.vz.sparse_shape}")
        me, bb, nk, hd = m["middle_encoder"], m["backbone"], m["neck"], m["head"]
        if me["block_type"] != "basicblock" or not hd["use_dcn"]:
            raise ValueError("the reference is the residual encoder with the DCN head")
        self.pts_middle_encoder = ResidualSparseEncoder(
            self.vz.sparse_shape, me["in_channels"], me["base_channels"],
            me["encoder_channels"], me["out_channels"])
        self.pts_backbone = SECONDBackbone(self.pts_middle_encoder.bev_channels,
                                           bb["out_channels"], bb["layer_nums"],
                                           bb["layer_strides"])
        self.pts_neck = SECONDFPN(nk["in_channels"], nk["out_channels"], nk["upsample_strides"])
        self.pts_bbox_head = CenterHead(hd["in_channels"], tasks(m), hd["share_conv_channels"],
                                        hd["common_heads"], hd["dcn_groups"])
        adv = m["adversary"]
        self.adversary = VoxelPerturber(self.num_features, adv["sensor_error_bound"],
                                        adv["use_spatial_attention"],
                                        tuple(adv["hidden_channels"]))

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor, train: bool,
                epoch: float, attack: bool, adv_grad_scale: float):
        """(the tasks' outputs, the adversary's terms)."""
        points, points_mask = inline_inputs(points, points_mask, self)
        plan = sparse_plan_core(points, points_mask, self.vz, self.num_features)
        self.train(train)
        voxels = plan["voxels"]
        grid = SparseGrid(plan["grid_ids"], plan["grid_coords"], plan["grid_mask"],
                          (voxels.shape[0],) + self.vz.sparse_shape)
        aux = {"l2_norm": voxels.new_zeros(())}
        if train or attack:
            voxels, aux = apply_voxel_adversary(self.adversary, points, voxels, plan, attack,
                                                epoch, self.start_epoch, adv_grad_scale)
        feats = HardSimpleVFE(voxels, plan["point_mask"])
        feats = feats.reshape(-1, feats.shape[-1])[plan["order"].long()]
        bev = self.pts_middle_encoder(feats, grid, plan["enc"])
        return self.pts_bbox_head(self.pts_neck(self.pts_backbone(bev))), aux


class Reference:
    """The float32 model of `cfg` on `device`."""

    def __init__(self, cfg: Dict, device: torch.device):
        self.cfg = cfg
        m = cfg["model"]
        self.model = AdversarialCenterPoint(m).to(device)
        self.tasks = tasks(m)
        self.head = head_fields(m)
        self.feat = bev_size(m)

    def train_loss(self, batch: Dict[str, torch.Tensor], epoch: float):
        """(the scalar the step differentiates, the detection loss, the
        adversary's logs, the head's outputs), the adversary on: its
        gradient reversal at -min(w * epoch / 10, w), its L2 regulariser
        added."""
        m = self.cfg["model"]
        w = m["adversarial_loss_weight"]
        ramp = min(w * float(epoch) / 10.0, w)
        preds, aux = self.model(batch["points"], batch["points_mask"], True, epoch, False, -ramp)
        tg = cd.targets(batch["gt_boxes"].float(), batch["gt_labels"], batch["gt_mask"].bool(),
                        batch["gt_vel"].float(), self.tasks, self.feat, self.head)
        l_hm, l_bbox = cd.loss(preds, tg, self.head)
        det = l_hm + l_bbox
        total = det + m["regularization_weight"] * aux["l2_norm"]
        return total, det, {"perturbation_l2_norm": aux["l2_norm"].detach()}, flatten(preds)

    @torch.no_grad()
    def eval_heads(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The head's outputs under the learned attack at its evaluation bounds."""
        preds, _ = self.model(batch["points"], batch["points_mask"], False, 100, True, -1.0)
        return flatten(preds)

    @torch.no_grad()
    def decode(self, heads: Dict[str, torch.Tensor]):
        """Top-k and per-task circle NMS -> (boxes, scores, labels, valid)."""
        return cd.decode(unflatten(heads, len(self.tasks)), self.tasks, self.head)
