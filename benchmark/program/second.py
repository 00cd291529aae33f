"""The port's SECOND family as the benchmark drives it: the trainer and the
serving function of a configuration file, and the head whose outputs the
check reads."""
from __future__ import annotations

from typing import Dict

import torch

from robustpointclouds_tpu_torch.cli.export import export_serving
from robustpointclouds_tpu_torch.data.synthetic import PointCloudBatch
from robustpointclouds_tpu_torch.models.detection import AnchorHeadConfig
from robustpointclouds_tpu_torch.models.voxelnet import AdversarialVoxelNet, VoxelNetConfig
from robustpointclouds_tpu_torch.ops.voxelize import VoxelizerConfig
from robustpointclouds_tpu_torch.train.loop import TrainConfig, Trainer

from ..reference import second as reference


def model_config(m: Dict) -> VoxelNetConfig:
    return reference.model_config(m, (VoxelNetConfig, VoxelizerConfig, AnchorHeadConfig),
                                  compute_dtype=m["compute_dtype"])


def check_architecture(model: AdversarialVoxelNet, m: Dict) -> None:
    """Raises where the built model is not the configuration file's."""
    enc = model.middle_encoder
    me = m["middle_encoder"]
    found = {"sparse_shape": list(model.sparse_shape),
             "encoder_channels": [list(s) for s in enc.encoder_channels],
             "residual": enc.residual,
             "backbone": [b[0].weight.shape[0] for b in model.backbone.blocks],
             "neck": [d[0].weight.shape[1] for d in model.neck.deblocks],
             "adversary": [getattr(model.adversary, f"mlp_{i}").out_features
                           for i in range(model.adversary.num_layers)]}
    hc = m["adversary"]["hidden_channels"]
    want = {"sparse_shape": m["sparse_shape"], "encoder_channels": me["encoder_channels"],
            "residual": me["block_type"] == "basicblock",
            "backbone": m["backbone"]["out_channels"], "neck": m["neck"]["out_channels"],
            "adversary": hc + hc[-2::-1]}
    if found != want:
        raise ValueError(f"the port's model is not the configuration's: {found} != {want}")


def batch(b: Dict[str, torch.Tensor]) -> PointCloudBatch:
    return PointCloudBatch(b["points"], b["points_mask"], b["gt_boxes"], b["gt_labels"],
                           b["gt_mask"])


def trainer(cfg: Dict, device: torch.device) -> Trainer:
    opt = dict(cfg["optim"], betas=tuple(cfg["optim"]["betas"]))
    t = Trainer(model_config(cfg["model"]), TrainConfig(**opt), device=device)
    check_architecture(t.model, cfg["model"])
    return t


def train_head(t: Trainer) -> torch.nn.Module:
    """The module whose forward output is the head's in the train step."""
    return t.model.bbox_head


def train_step(t: Trainer, b, epoch: float) -> Dict[str, torch.Tensor]:
    """The timed call: one inline adversarial train step (plan=None)."""
    return t.train_step(b, epoch, None)


def server(cfg: Dict, device: torch.device, state_dict: Dict[str, torch.Tensor]):
    """(serve, the module whose forward output is the head's)."""
    net_cfg = model_config(cfg["model"])
    model = AdversarialVoxelNet(net_cfg)
    check_architecture(model, cfg["model"])
    anchors, _ = net_cfg.make_anchors()
    return export_serving(model, state_dict, anchors, net_cfg.head, device=device), model.bbox_head


def heads(output) -> Dict[str, torch.Tensor]:
    cls, bbox, dirs = output
    return {"cls": cls, "bbox": bbox, "dir": dirs}
