"""The SECOND family in the plain reference: the model of a configuration
file in float32, its train loss, its eval head outputs and their decode."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .plain.models import detection, voxelnet
from .plain.ops.voxelize import VoxelizerConfig


def model_config(m: Dict, classes=(voxelnet.VoxelNetConfig, VoxelizerConfig,
                                   detection.AnchorHeadConfig), compute_dtype: str = "float32"):
    """The configuration file's "model" group as a VoxelNetConfig of
    `classes` (the plain reference's, or another implementation's of the
    same fields)."""
    net_cls, vox_cls, head_cls = classes
    vz = m["voxelizer"]
    head = {k: tuple(v) if isinstance(v, list) else v for k, v in m["head"].items()}
    return net_cls(
        voxelizer=vox_cls(tuple(vz["point_cloud_range"]), tuple(vz["voxel_size"]),
                          int(vz["max_points_per_voxel"]), int(vz["max_voxels"])),
        num_classes=int(m["num_classes"]),
        class_names=tuple(m["class_names"]),
        anchor_ranges=tuple(tuple(r) for r in m["anchor_ranges"]),
        anchor_sizes=tuple(tuple(s) for s in m["anchor_sizes"]),
        anchor_rotations=tuple(m["anchor_rotations"]),
        head=head_cls(**head),
        adversary={k: tuple(v) if isinstance(v, list) else v
                   for k, v in m["adversary"].items()},
        adversarial_loss_weight=float(m["adversarial_loss_weight"]),
        regularization_weight=float(m["regularization_weight"]),
        adversary_start_epoch=int(m["adversary_start_epoch"]),
        compute_dtype=compute_dtype,
    )


class Reference:
    """The float32 model of `cfg` on `device` with its anchors."""

    def __init__(self, cfg: Dict, device: torch.device):
        self.cfg = cfg
        self.net_cfg = model_config(cfg["model"])
        self.model = voxelnet.AdversarialVoxelNet(self.net_cfg).to(device)
        a, c = self.net_cfg.make_anchors()
        self.anchors = torch.as_tensor(a, device=device)
        self.anchor_cls = torch.as_tensor(c, device=device)

    def train_loss(self, batch: Dict[str, torch.Tensor], epoch: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
        """(the scalar the step differentiates, the detection loss, the
        adversary's logs, the head's outputs), the adversary on (gradient
        reversal at -adversarial_loss_weight)."""
        opt = self.cfg["optim"]
        outs = self.model(batch["points"], batch["points_mask"], True, epoch, False,
                          -opt["adversarial_loss_weight"], None)
        det = detection.anchor_head_loss(outs.cls_scores, outs.bbox_preds, outs.dir_preds,
                                         self.anchors, self.anchor_cls, batch["gt_boxes"],
                                         batch["gt_labels"], batch["gt_mask"],
                                         self.net_cfg.head)
        det_total = det["loss_cls"] + det["loss_bbox"] + det["loss_dir"]
        adv_total, logs = voxelnet.adversary_direct_terms(det, outs.adv_aux, epoch,
                                                          opt["regularization_weight"])
        heads = {"cls": outs.cls_scores, "bbox": outs.bbox_preds, "dir": outs.dir_preds}
        return det_total + adv_total, det_total, logs, heads

    @torch.no_grad()
    def eval_heads(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The head's outputs under the learned attack at its evaluation bounds."""
        outs = self.model(batch["points"], batch["points_mask"], False, 100, True, -1.0, None)
        return {"cls": outs.cls_scores, "bbox": outs.bbox_preds, "dir": outs.dir_preds}

    @torch.no_grad()
    def decode(self, heads: Dict[str, torch.Tensor]):
        """Decode and per-class rotated NMS -> (boxes, scores, labels, valid)."""
        return detection.anchor_head_predict(heads["cls"], heads["bbox"], heads["dir"],
                                             self.anchors, self.net_cfg.head)
