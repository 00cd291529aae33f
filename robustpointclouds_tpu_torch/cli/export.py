"""The serving forward (counterpart of `serve` in robustpointclouds_tpu/cli/export.export_serving).

`export_serving(model, state_dict, anchors, head)` returns
`serve(points, mask, plan, attack=False) -> (boxes, scores, labels,
valid)`: the plan-fed model forward with the weights loaded, then
  * SECOND (AdversarialVoxelNet) and PointPillars (AdversarialPointPillars,
    on the native pillar plan): anchor decode + rotated NMS, boxes [B, K, 7];
  * CenterPoint (AdversarialCenterPoint, `anchors` None): per-task heatmap
    top-k + circle NMS (models/center_detection.centerpoint_decode), boxes
    [B, K, 9] with the velocity.
`attack=True` is the learned adversary's evaluation-under-attack mode.
Serialising the graph (torch.export) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.center_detection import CenterHeadConfig, centerpoint_decode
from ..models.centerpoint import AdversarialCenterPoint
from ..models.detection import AnchorHeadConfig, anchor_head_predict
from ..models.pointpillars import AdversarialPointPillars
from ..models.voxelnet import AdversarialVoxelNet, plan_to_device


def export_serving(model: Union[AdversarialVoxelNet, AdversarialPointPillars,
                                AdversarialCenterPoint],
                   state_dict: Optional[Dict[str, torch.Tensor]],
                   anchors: Optional[np.ndarray], head: Union[AnchorHeadConfig, CenterHeadConfig],
                   device: Optional[Union[str, torch.device]] = None) -> Callable:
    """Bind weights, anchors (SECOND, PointPillars; None for CenterPoint) and the head
    config into a serving function.

    Runs on the card unless `device` asks for another; raises when no card
    is there and none was asked for. `state_dict=None` keeps the model's own
    weights.
    """
    dev = resolve_device(device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(dev).eval()
    centerpoint = isinstance(model, AdversarialCenterPoint)
    if not centerpoint:
        anchors_t = torch.as_tensor(np.asarray(anchors, np.float32), device=dev)

    @torch.no_grad()
    def serve(points, mask, plan, attack: bool = False):
        """`plan`: the native host plan's dict (numpy or on the device)."""
        plan_t = plan_to_device(plan, dev)
        outs = model(points, mask, False, 100, attack, -1.0, plan_t)
        if centerpoint:
            return centerpoint_decode(outs.task_preds, head)
        return anchor_head_predict(outs.cls_scores, outs.bbox_preds, outs.dir_preds,
                                   anchors_t, head)

    return serve
