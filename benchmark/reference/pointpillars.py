"""The PointPillars family in the plain reference: the model of a
configuration file in float32, its train loss, its eval head outputs and
their decode (SECOND's, reference/second.py: the same anchor head, losses
and adversary terms)."""
from __future__ import annotations

import functools
from typing import Dict

import torch

from . import second
from .plain.models import detection, pointpillars
from .plain.ops.voxelize import VoxelizerConfig


def model_config(m: Dict, classes=(pointpillars.PointPillarsConfig, VoxelizerConfig,
                                   detection.AnchorHeadConfig), compute_dtype: str = "float32"):
    """The configuration file's "model" group as a PointPillarsConfig of
    `classes` (the plain reference's, or another implementation's of the
    same fields): SECOND's fields and the pillar body's widths."""
    net_cls, vox_cls, head_cls = classes
    bb, neck = m["backbone"], m["neck"]
    widths = functools.partial(
        net_cls, pfn_channels=int(m["pfn_channels"]),
        backbone_channels=tuple(bb["out_channels"]), backbone_layers=tuple(bb["layer_nums"]),
        backbone_strides=tuple(bb["layer_strides"]), fpn_channels=tuple(neck["out_channels"]),
        fpn_strides=tuple(neck["upsample_strides"]))
    return second.model_config(m, (widths, vox_cls, head_cls), compute_dtype)


class Reference(second.Reference):
    """The float32 model of `cfg` on `device` with its anchors."""

    def __init__(self, cfg: Dict, device: torch.device):
        self.cfg = cfg
        self.net_cfg = model_config(cfg["model"])
        self.model = pointpillars.AdversarialPointPillars(self.net_cfg).to(device)
        a, c = self.net_cfg.make_anchors()
        self.anchors = torch.as_tensor(a, device=device)
        self.anchor_cls = torch.as_tensor(c, device=device)
