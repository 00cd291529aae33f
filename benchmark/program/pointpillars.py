"""The port's PointPillars family as the benchmark drives it: the trainer and
the serving function of a configuration file, and the head whose outputs the
check reads."""
from __future__ import annotations

from typing import Dict

import torch

from robustpointclouds_tpu_torch.cli.export import export_serving
from robustpointclouds_tpu_torch.models.detection import AnchorHeadConfig
from robustpointclouds_tpu_torch.models.pointpillars import (AdversarialPointPillars,
                                                             PointPillarsConfig)
from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig
from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

from ..reference import pointpillars as reference
from .second import batch, heads, train_head, train_step  # noqa: F401  (the family's contract)


def model_config(m: Dict) -> PointPillarsConfig:
    return reference.model_config(m, (PointPillarsConfig, VoxelizerConfig, AnchorHeadConfig),
                                  compute_dtype=m["compute_dtype"])


def check_architecture(model: AdversarialPointPillars, m: Dict) -> None:
    """Raises where the built model is not the configuration file's."""
    nx, ny, _ = model.cfg.voxelizer.grid_size
    pfn = model.voxel_encoder.pfn_layers[0].linear
    blocks = model.backbone.blocks
    found = {"bev_shape": [ny, nx], "pfn": [pfn.in_features, pfn.out_features],
             "backbone_in": blocks[0][0].weight.shape[1],
             "backbone": [b[0].weight.shape[0] for b in blocks],
             "layer_nums": [len(b) // 3 - 1 for b in blocks],
             "layer_strides": [b[0].stride[0] for b in blocks],
             "neck": [d[0].weight.shape[1] for d in model.neck.deblocks],
             "upsample": [d[0].stride[0] for d in model.neck.deblocks],
             "head_in": model.bbox_head.conv_cls.weight.shape[1],
             "adversary": [getattr(model.adversary, f"mlp_{i}").out_features
                           for i in range(model.adversary.num_layers)]}
    bb, neck, hc = m["backbone"], m["neck"], m["adversary"]["hidden_channels"]
    want = {"bev_shape": m["bev_shape"], "pfn": [m["pfn_in_features"], m["pfn_channels"]],
            "backbone_in": bb["in_channels"], "backbone": bb["out_channels"],
            "layer_nums": bb["layer_nums"], "layer_strides": bb["layer_strides"],
            "neck": neck["out_channels"],
            "upsample": neck["upsample_strides"], "head_in": sum(neck["out_channels"]),
            "adversary": hc + hc[-2::-1]}
    if found != want:
        raise ValueError(f"the port's model is not the configuration's: {found} != {want}")


def trainer(cfg: Dict, device: torch.device) -> Trainer:
    opt = dict(cfg["optim"], betas=tuple(cfg["optim"]["betas"]))
    t = Trainer(model_config(cfg["model"]), TrainConfig(**opt), device=device)
    check_architecture(t.model, cfg["model"])
    return t


def server(cfg: Dict, device: torch.device, state_dict: Dict[str, torch.Tensor]):
    """(serve, the module whose forward output is the head's)."""
    net_cfg = model_config(cfg["model"])
    model = AdversarialPointPillars(net_cfg)
    check_architecture(model, cfg["model"])
    anchors, _ = net_cfg.make_anchors()
    return export_serving(model, state_dict, anchors, net_cfg.head, device=device), model.bbox_head
