"""CenterPoint min-max trainer, the NuScenes path (counterpart of robustpointclouds_tpu/train/centerpoint_loop.py).

The train/loop.Trainer step (one backward, the two optimizer chains, the
gradient sanitation, the BN restore on a NaN step and the device-side NaN
ladder) with CenterPoint's losses: the heatmap focal loss and the
regression L1 (models/center_detection.centerpoint_loss) on the targets the
host plan carries, plus the adversary's L2 regulariser; the adversary's
objective -min(w * epoch / 10, w) * det total rides on the gradient-reversal
scale of its perturbation delta (the reference's epoch-ramped adaptive
weight). With `plan=None` the step is inline, as JAX's: the model builds
the plan from the batch's points on the device and the targets are drawn
there from the batch's GTs and velocities. The reference recipe: AdamW lr
5e-5, clip 1.0, the adversary's lr multiplier 1.

PGD adversarial training (`pgd_steps`) raises, as the JAX trainer does:
training clean while the config asks for PGD-AT would make a fake robust
checkpoint. The data-parallel step (`compile_sharded(group)`) is
train/loop.Trainer's, as JAX's CenterPoint `_sharded_step_impl` is its
Trainer's: the rank's own rows and plan, then one all-reduce of the
gradients, BatchNorm running statistics and logs, and any rank's NaN a
NaN step on every rank.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.spans import span
from ..data.native_plan import build_plan_native
from ..models.center_detection import centerpoint_loss, centerpoint_targets
from ..models.centerpoint import (AdversarialCenterPoint, CenterPointConfig,
                                  centerpoint_adversary_terms)
from ..models.voxelnet import plan_to_device
from .loop import TrainConfig, Trainer, make_optimizers


class CenterPointPlanBuilder:
    """The host plan of one NuScenes batch: the native index plan over
    5-feature points and, given GTs, the CenterHead targets (CPU torch).
    Runs in the input pipeline's prefetch thread; returns numpy arrays.

    `timings` keeps, per call, the host-clock ms of the two parts
    ({"native_ms", "targets_ms", "plan_ms"}), the newest 1024 of them."""

    def __init__(self, model_cfg: CenterPointConfig):
        self._cfg = model_cfg
        self.timings: collections.deque = collections.deque(maxlen=1024)

    def __call__(self, points, points_mask, gt_boxes=None, gt_labels=None, gt_mask=None,
                 gt_vel=None):
        cfg = self._cfg
        t0 = time.perf_counter()
        plan = build_plan_native(np.asarray(points), np.asarray(points_mask), cfg.voxelizer,
                                 cfg.num_point_features)
        t1 = time.perf_counter()
        if gt_boxes is not None:
            plan["targets"] = [{k: v.numpy() for k, v in task.items()} for task in
                               centerpoint_targets(gt_boxes, gt_labels, gt_mask, gt_vel,
                                                   cfg.bev_feature_size, cfg.head)]
        t2 = time.perf_counter()
        self.timings.append({"native_ms": (t1 - t0) * 1e3, "targets_ms": (t2 - t1) * 1e3,
                             "plan_ms": (t2 - t0) * 1e3})
        return plan


CENTERPOINT_TRAIN = TrainConfig(learning_rate=5e-5, grad_clip_norm=1.0, adversary_lr_mult=1.0)


class CenterPointTrainer(Trainer):
    """Owns AdversarialCenterPoint, the two optimizer chains and the train
    state. Runs on the card unless `device` asks for another."""

    def __init__(self, model_cfg: CenterPointConfig = CenterPointConfig(),
                 train_cfg: TrainConfig = CENTERPOINT_TRAIN,
                 device: Optional[Union[str, torch.device]] = None):
        if train_cfg.pgd_steps:
            raise NotImplementedError(
                "pgd_steps (PGD adversarial training) is implemented for the anchor-head "
                "Trainer only; CenterPointTrainer does not run it")
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        self.model = AdversarialCenterPoint(model_cfg).to(self.device)
        self.det_tx, self.adv_tx = make_optimizers(train_cfg)
        self.state = None
        self._pgd = None

    def _loss_fn(self, gt, epoch: float, plan: Optional[Dict[str, Any]], points=(None, None)):
        """Forward + losses -> (total scalar, logs, is_nan). The GTs come in
        as the plan's "targets", or as `gt` itself, the targets of the
        inline step, whose forward builds the plan from `points`."""
        cfg = self.model_cfg
        adv_enabled = self.state.adversary_enabled
        ramp = min(cfg.adversarial_loss_weight * epoch / 10.0, cfg.adversarial_loss_weight)
        outs = self.model(*points, True, epoch, False, -ramp * adv_enabled, plan)
        with span("rpc.loss"):
            targets = gt if plan is None else plan["targets"]
            det = centerpoint_loss(outs.task_preds, targets, cfg.head)
            det_total = det["loss_heatmap"] + det["loss_bbox"]
            adv_direct, _, adv_logs = centerpoint_adversary_terms(
                det, outs.adv_aux, epoch, cfg.adversarial_loss_weight,
                cfg.regularization_weight)
            total = det_total + adv_enabled * adv_direct
            is_nan = ~torch.isfinite(total)
            total = torch.where(is_nan, torch.zeros_like(total), total)
            logs = {"loss": det_total.detach(), "loss_heatmap": det["loss_heatmap"].detach(),
                    "loss_bbox": det["loss_bbox"].detach(),
                    **{k: v.detach() for k, v in adv_logs.items()}}
        return total, logs, is_nan

    def train_step(self, batch, epoch: float, plan: Optional[Dict[str, Any]] = None,
                   gt_vel=None) -> Dict[str, torch.Tensor]:
        """One step on a host plan with "targets" (CenterPointPlanBuilder
        given the GTs; `batch` is then not read), or inline with plan=None:
        the plan from the batch's points and the targets from its GTs and
        `gt_vel` [B, G, 2], both on the device (the targets under the span
        `rpc.targets`). Train/loop.Trainer's step otherwise, spans included.
        Returns the logs as device scalars."""
        return self._step(batch, epoch, plan, lambda b, p: self._step_inputs(b, p, gt_vel))

    def _step_inputs(self, batch, plan: Optional[Dict[str, Any]], gt_vel):
        """(the inline step's targets or None, the plan on the device or None)."""
        if plan is not None:
            return None, plan_to_device(plan, self.device)
        if gt_vel is None:
            raise ValueError("the inline CenterPoint step (plan=None) needs gt_vel")
        with span("rpc.targets"):
            gt, _ = self._to_device(batch, None)
            return centerpoint_targets(*gt, self._tensor(gt_vel).float(),
                                       self.model_cfg.bev_feature_size,
                                       self.model_cfg.head), None

    def make_plan_builder(self) -> CenterPointPlanBuilder:
        return CenterPointPlanBuilder(self.model_cfg)
