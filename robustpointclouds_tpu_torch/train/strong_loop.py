"""The strong family's trainer: momentum carry, dynamic scaling, anti-adaptation (counterpart of robustpointclouds_tpu/train/strong_loop.py).

Drives StrongAdversarialVoxelNet with the reference's training dynamics
(train_kitti_adversarial_strong.py: batch 1, 10 epochs, validation every 2;
dynamic scaling updated from the attack-effectiveness history,
strong_voxel_perturber.py:214-254; anti-adaptation with probability p
scaling the detector's losses x0.1, strong_adversarial_voxelnet.py:251-255).

A step: curriculum min(1 + step/10000, 2) folded into the scale (capped at
`max_scaling`) -> the plan-fed forward in train mode with the carried
perturbations and the gradient-reversal factor -w * enabled * scale on the
deltas -> anchor_head_loss, x0.1 on an anti-adaptation draw ->
+ enabled * the momentum term -> one backward -> the sanitised gradients
through the two optimizer chains of train/loop.Trainer (split by the
adversary's parameters; BN stats kept on a NaN step; the device NaN
ladder). The step's perturbations become the next step's momentum.

Dropout masks and the anti-adaptation flag are drawn from the trainer's own
`torch.Generator` on its device (never the global one), seeded by
init_state; torch cannot replay JAX's keys, so those draws are the same in
distribution only. The dynamic scale's host history and its
`np.random.RandomState(0)` jitter are plain numpy, as JAX's are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..models.detection import anchor_head_loss
from ..models.strong import StrongAdversarialVoxelNet, StrongVoxelNetConfig, strong_adversary_terms
from ..models.voxelnet import plan_to_device
from ..nn.perturber import strong_dynamic_scale
from .loop import HostPlanBuilder, TrainConfig, Trainer, TrainState


@dataclasses.dataclass
class StrongTrainState(TrainState):
    """TrainState plus the strong family's carries."""

    momentum: torch.Tensor       # [B * max_voxels, 4] float32: the last step's perturbations
    scale_factor: torch.Tensor   # float32 scalar: the dynamic scale (host-updated)


class StrongTrainer(Trainer):
    """Trainer of StrongAdversarialVoxelNet on the SECOND plan of `cfg.base`.

    Runs on the card unless `device` asks for another (core/device)."""

    state_cls = StrongTrainState

    def __init__(self, model_cfg: StrongVoxelNetConfig = StrongVoxelNetConfig(),
                 train_cfg: TrainConfig = TrainConfig(),
                 device: Optional[Union[str, torch.device]] = None):
        if getattr(train_cfg, "pgd_steps", 0):
            # fail loudly rather than silently training without PGD-AT
            raise NotImplementedError(
                "pgd_steps (PGD adversarial training) is implemented for the anchor-head "
                "Trainer only; StrongTrainer does not run it")
        super().__init__(model_cfg, train_cfg, device)
        # the host-side attack-effectiveness history (the reference keeps python lists)
        self.effectiveness_history: List[float] = []
        self.magnitude_history: List[float] = []
        self._np_rng = np.random.RandomState(0)
        self.generator = torch.Generator(device=self.device)
        self._pert: Optional[torch.Tensor] = None

    @staticmethod
    def _make_model(model_cfg) -> StrongAdversarialVoxelNet:
        if not isinstance(model_cfg, StrongVoxelNetConfig):
            raise TypeError(f"StrongTrainer takes a StrongVoxelNetConfig, not "
                            f"{type(model_cfg).__name__}")
        return StrongAdversarialVoxelNet(model_cfg)

    def init_state(self, seed: int = 0, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                   batch_size: int = 1) -> StrongTrainState:
        """Trainer.init_state, a zero momentum carry for batches of
        `batch_size`, scale 1, and the dropout / anti-adaptation generator
        seeded with `seed`."""
        base = super().init_state(seed, state_dict)
        n = batch_size * self.model_cfg.base.voxelizer.max_voxels
        self.generator.manual_seed(seed)
        self.state = StrongTrainState(
            **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
            momentum=torch.zeros((n, 4), dtype=torch.float32, device=self.device),
            scale_factor=torch.ones((), dtype=torch.float32, device=self.device))
        return self.state

    def make_plan_builder(self) -> HostPlanBuilder:
        """The SECOND host plan of the base detector config (the strong
        variant shares its voxelizer, encoder geometry and anchors)."""
        return HostPlanBuilder(self.model_cfg.base)

    # -- the step -------------------------------------------------------------
    def _loss_fn(self, gt, epoch: float, plan: Optional[Dict[str, Any]], points=(None, None)):
        """Forward + losses -> (total scalar, logs, is_nan), as the JAX
        _loss_fn; the step's perturbations are kept for the carry. With no
        plan the forward builds it from `points` and the loss assigns."""
        cfg, st = self.model_cfg, self.state
        # the curriculum in float32, as the JAX step computes it from its int32 step
        curriculum = float(np.minimum(np.float32(1.0) + np.float32(st.step) / np.float32(1e4),
                                      np.float32(2.0)))
        scale = torch.clamp(st.scale_factor * curriculum, max=cfg.max_scaling)
        enabled = st.adversary_enabled
        outs = self.model(*points, True, scale, st.momentum,
                          -cfg.adversarial_loss_weight * enabled * scale, True, plan,
                          generator=self.generator)
        gt_boxes, gt_labels, gt_mask = gt
        det = anchor_head_loss(outs.cls_scores, outs.bbox_preds, outs.dir_preds, self.anchors,
                               self.anchor_cls, gt_boxes, gt_labels, gt_mask, cfg.base.head,
                               assign=None if plan is None else plan.get("assign"))
        det_total = det["loss_cls"] + det["loss_bbox"] + det["loss_dir"]
        # anti-adaptation: now and then starve the detector (x0.1)
        anti = self._anti_draw()
        det_total = det_total * torch.where(anti, 0.1, 1.0)
        adv_direct, adv_logs = strong_adversary_terms(outs.adv_aux, outs.perturbations,
                                                      st.momentum, cfg.momentum_loss_weight)
        total = det_total + enabled * adv_direct
        is_nan = ~torch.isfinite(total)
        total = torch.where(is_nan, torch.zeros_like(total), total)
        self._pert = outs.perturbations.detach()
        logs = {"loss": det_total, "loss_cls": det["loss_cls"], "loss_bbox": det["loss_bbox"],
                "loss_dir": det["loss_dir"], "loss_adversarial": -det_total,
                "attack_scale": scale, "anti_adaptation": anti.to(torch.float32), **adv_logs}
        return total, {k: v.detach() for k, v in logs.items()}, is_nan

    def _anti_draw(self) -> torch.Tensor:
        """The step's anti-adaptation flag: a uniform draw of the trainer's
        generator below anti_adaptation_prob (JAX's bernoulli), on the device."""
        u = torch.rand((), generator=self.generator, device=self.generator.device)
        return u.to(self.device) < self.model_cfg.anti_adaptation_prob

    def _rows(self, batch, plan) -> int:
        """Voxel rows of a batch: the plan's, or B * max_voxels inline."""
        if plan is not None:
            return len(plan["order"])
        return len(batch.points) * self.model_cfg.base.voxelizer.max_voxels

    def train_step(self, batch, epoch: float = 0, plan: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on `batch` with its host plan (HostPlanBuilder on
        cfg.base, with "assign"), or inline with plan=None (plan and
        assignment built on the device); `epoch` is not read (the dynamic
        scale carries it). The momentum carry is re-zeroed when the batch's
        voxel rows differ from it (another batch size)."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        rows = self._rows(batch, plan)
        if self.state.momentum.shape[0] != rows:
            self.state.momentum = torch.zeros((rows, 4), dtype=torch.float32,
                                              device=self.device)
        logs = super().train_step(batch, epoch, plan)
        self.state.momentum = self._pert
        return logs

    # -- eval -----------------------------------------------------------------
    @torch.no_grad()
    def forward_eval(self, plan: Optional[Dict[str, Any]] = None, attack: bool = False,
                     batch=None):
        """Clean eval (no perturbation) or attack eval (the perturbation
        forced at the current dynamic scale with the carried momentum, the
        strong variant's analogue of the reference's forced-perturbation
        attack eval) on a host plan, or inline (plan=None) on the points of
        `batch`, voxelised on the device as JAX's forward_eval does. A batch
        of another row count than the carry (another batch size) runs
        without the momentum term."""
        self.model.eval()
        plan = None if plan is None else plan_to_device(plan, self.device)
        points = self._points(batch, plan)
        if not attack:
            return self.model(*points, False, 1.0, None, 0.0, False, plan)
        st = self.state
        last = st.momentum if st.momentum.shape[0] == self._rows(batch, plan) else None
        return self.model(*points, False, st.scale_factor, last, 0.0, True, plan)

    # -- host-side dynamic scaling (the reference's update_dynamic_scaling) ---
    def update_dynamic_scaling(self, state: StrongTrainState, epoch: int,
                               logs: Optional[Dict[str, Any]] = None) -> StrongTrainState:
        if logs is not None:
            self.effectiveness_history.append(abs(float(logs["loss_adversarial"]))
                                              / max(float(logs["loss"]), 1e-6) - 1.0)
            self.magnitude_history.append(float(logs["perturbation_l2_norm"]))
            self.effectiveness_history = self.effectiveness_history[-1000:]
            self.magnitude_history = self.magnitude_history[-1000:]
        eff = (float(np.mean(self.effectiveness_history[-20:]))
               if len(self.effectiveness_history) > 20 else None)
        mag = (float(np.mean(self.magnitude_history[-50:]))
               if len(self.magnitude_history) > 50 else None)
        jitter = float(self._np_rng.normal(0, 0.05))
        scale = strong_dynamic_scale(epoch, eff, mag, jitter, self.model_cfg.max_scaling)
        state.scale_factor = torch.tensor(scale, dtype=torch.float32, device=self.device)
        return state

    def reset_momentum(self, state: StrongTrainState) -> StrongTrainState:
        state.momentum = torch.zeros_like(state.momentum)
        return state
