"""The port's CenterPoint family as the benchmark drives it: the trainer and
the serving function of a configuration file, and the head whose outputs
the check reads."""
from __future__ import annotations

from typing import Dict

import torch

from robustpointclouds_tpu_torch.cli.export import export_serving
from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch
from robustpointclouds_tpu_torch.models.center_detection import CenterHeadConfig
from robustpointclouds_tpu_torch.models.centerpoint import (AdversarialCenterPoint,
                                                            CenterPointConfig)
from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig
from robustpointclouds_tpu_torch.train.centerpoint_loop import CenterPointTrainer
from robustpointclouds_tpu_torch.train.loop import TrainConfig

from ..reference import centerpoint as reference


def model_config(m: Dict) -> CenterPointConfig:
    tasks = reference.tasks(m)
    return CenterPointConfig(
        voxelizer=reference.voxelizer_config(m, VoxelizerConfig),
        num_point_features=int(m["num_point_features"]),
        encoder_channels=tuple(tuple(s) for s in m["middle_encoder"]["encoder_channels"]),
        residual_encoder=m["middle_encoder"]["block_type"] == "basicblock",
        tasks=tasks,
        head=CenterHeadConfig(tasks=tasks, **reference.head_fields(m)),
        adversary={k: tuple(v) if isinstance(v, list) else v for k, v in m["adversary"].items()},
        adversarial_loss_weight=float(m["adversarial_loss_weight"]),
        regularization_weight=float(m["regularization_weight"]),
        adversary_start_epoch=int(m["adversary_start_epoch"]),
        compute_dtype=m["compute_dtype"],
        use_dcn_head=bool(m["head"]["use_dcn"]))


def check_architecture(model: AdversarialCenterPoint, m: Dict) -> None:
    """Raises where the built model is not the configuration file's."""
    enc = model.pts_middle_encoder
    head = model.pts_bbox_head
    me, hd = m["middle_encoder"], m["head"]
    t0 = head.task_heads[0]
    dcn = getattr(t0, "feature_adapt_cls", None)
    found = {"sparse_shape": list(model.cfg.voxelizer.sparse_shape),
             "in_channels": enc.conv_input[0].weight.shape[-1],
             "encoder_channels": [list(s) for s in enc.encoder_channels],
             "residual": enc.residual, "out_channels": enc.conv_out[0].weight.shape[0],
             "backbone": [b[0].weight.shape[0] for b in model.pts_backbone.blocks],
             "neck": [d[0].weight.shape[1] for d in model.pts_neck.deblocks],
             "head_in": head.shared_conv.conv.weight.shape[1],
             "share": head.shared_conv.conv.weight.shape[0],
             "tasks": [[list(n), len((t.cls_head if head.use_dcn else t.heatmap)[1].bias)]
                       for n, t in zip(model.cfg.tasks, head.task_heads)],
             "common_heads": [[n, d] for n, d in head.common_heads],
             "dcn": head.use_dcn, "dcn_groups": None if dcn is None else dcn.dcn.groups,
             "adversary": [getattr(model.adversary, f"mlp_{i}").out_features
                           for i in range(model.adversary.num_layers)]}
    hc = m["adversary"]["hidden_channels"]
    want = {"sparse_shape": m["sparse_shape"], "in_channels": me["in_channels"],
            "encoder_channels": me["encoder_channels"],
            "residual": me["block_type"] == "basicblock", "out_channels": me["out_channels"],
            "backbone": m["backbone"]["out_channels"], "neck": m["neck"]["out_channels"],
            "head_in": hd["in_channels"], "share": hd["share_conv_channels"],
            "tasks": [[t, len(t)] for t in hd["tasks"]], "common_heads": hd["common_heads"],
            "dcn": hd["use_dcn"], "dcn_groups": hd["dcn_groups"] if hd["use_dcn"] else None,
            "adversary": hc + hc[-2::-1]}
    if found != want:
        raise ValueError(f"the port's model is not the configuration's: {found} != {want}")


def batch(b: Dict[str, torch.Tensor]):
    """(the frames and their GTs, the GTs' velocities [B, G, 2])."""
    return (PointCloudBatch(b["points"], b["points_mask"], b["gt_boxes"], b["gt_labels"],
                            b["gt_mask"]), b["gt_vel"])


def trainer(cfg: Dict, device: torch.device) -> CenterPointTrainer:
    opt = dict(cfg["optim"], betas=tuple(cfg["optim"]["betas"]))
    t = CenterPointTrainer(model_config(cfg["model"]), TrainConfig(**opt), device=device)
    check_architecture(t.model, cfg["model"])
    return t


def train_head(t: CenterPointTrainer) -> torch.nn.Module:
    """The module whose forward output is the head's in the train step."""
    return t.model.pts_bbox_head


def train_step(t: CenterPointTrainer, b, epoch: float) -> Dict[str, torch.Tensor]:
    """The timed call: one inline adversarial train step (plan=None), the
    targets drawn on the device."""
    frames, vel = b
    return t.train_step(frames, epoch, None, gt_vel=vel)


def server(cfg: Dict, device: torch.device, state_dict: Dict[str, torch.Tensor]):
    """(serve, the module whose forward output is the head's)."""
    net_cfg = model_config(cfg["model"])
    model = AdversarialCenterPoint(net_cfg)
    check_architecture(model, cfg["model"])
    return export_serving(model, state_dict, None, net_cfg.head, device=device), model.pts_bbox_head


def heads(output) -> Dict[str, torch.Tensor]:
    """The six tasks' outputs as {"task<t>.<branch>": tensor}."""
    return reference.flatten(output)
