"""White-box gradient attacks (FGSM / PGD) on the plan's voxels (counterpart of robustpointclouds_tpu/eval/attacks.py).

A PGD baseline (Madry et al., arXiv:1706.06083) under the learned
adversary's physical envelope, the attack-profile clamps of
nn/perturber._bound_profile; FGSM is its one-step case. The gradient flows
only to the plan's raw voxel features, the pre-encoder surface the learned
adversary perturbs, so the host plan (voxelisation and every sparse index)
is built once and the K steps rerun the plan-fed forward on the device.

The JAX version is one jitted fori_loop; here the loop is K Python steps of
`torch.autograd.grad(loss, delta)` with the model in eval mode. The model's
parameters are frozen (`requires_grad=False`) for the attack's duration:
the sparse conv's autograd Function decides at forward time, from its
inputs' `requires_grad`, whether its backward runs the weight-gradient
kernel, so without the freeze every step would launch 12 wasted wgrads.
The forward and the input-gradient (dgrad) kernels run once per conv and
step: the perturbation reaches conv_input's features.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from ..models.detection import anchor_head_loss
from ..nn.perturber import _bound_profile
from ..ops import assigner


@contextlib.contextmanager
def frozen(model: torch.nn.Module):
    """The model's parameters with requires_grad off, restored on exit."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield model
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


class PlanAttack:
    """`attack(batch, plan) -> attacked plan` on the trainer's device.

    `trainer`: the plan-fed anchor-head train/loop.Trainer. The attack
    perturbs `plan["voxels"]` within the per-feature attack clamp (spatial
    +-25*e = 5.0 m and intensity 2.0 at e = 0.2, the envelope the learned
    attack's outputs are clamped to) and maximises the detection loss
    against the batch's GTs. Padding slots (point_mask False) stay untouched.
    rel_step: the step size as a multiple of the clamp over the whole run
    (alpha = rel_step * clamp / steps; Madry's 2.5). FGSM = steps 1,
    rel_step 1.0 (one signed step to the boundary).
    """

    def __init__(self, trainer, steps: int = 10, rel_step: float = 2.5):
        self.trainer = trainer
        self.steps = steps
        self.rel_step = rel_step
        adv_cfg = trainer.model_cfg.adversary or {}
        self.bound = float(adv_cfg.get("sensor_error_bound", 0.2))

    def prepare(self, batch, plan: Dict[str, Any]):
        """(GT tensors, the plan on the device with its anchor assignment).
        The assignment is parameter-free (anchors vs GTs), so it is computed
        once here, not at every step, when the plan does not carry it."""
        tr = self.trainer
        gt, plan_t = tr._to_device(batch, plan)
        if "assign" not in plan_t:
            head = tr.model_cfg.head
            res = assigner.assign(tr.anchors, tr.anchor_cls, *gt, head.pos_iou_thr,
                                  head.neg_iou_thr, head.min_pos_iou)
            plan_t["assign"] = {"labels": res.labels, "matched_gt": res.matched_gt,
                                "pos_mask": res.pos_mask, "neg_mask": res.neg_mask}
        return gt, plan_t

    def loss_grad(self, delta: torch.Tensor, gt, plan_t: Dict[str, Any]) -> torch.Tensor:
        """d(detection loss)/d(delta) of the eval-mode forward on the plan's
        voxels + delta on the valid slots. Call with the model frozen."""
        tr = self.trainer
        delta = delta.detach().requires_grad_(True)
        with torch.enable_grad():
            m = plan_t["point_mask"][..., None].to(plan_t["voxels"].dtype)
            outs = tr.model(None, None, False, 100, False, -1.0,
                            dict(plan_t, voxels=plan_t["voxels"] + delta * m))
            det = anchor_head_loss(outs.cls_scores, outs.bbox_preds, outs.dir_preds,
                                   tr.anchors, tr.anchor_cls, *gt, tr.model_cfg.head,
                                   assign=plan_t["assign"])
            (g,) = torch.autograd.grad(det["loss_cls"] + det["loss_bbox"] + det["loss_dir"],
                                       delta)
        return g

    def __call__(self, batch, plan: Dict[str, Any]) -> Dict[str, Any]:
        gt, plan_t = self.prepare(batch, plan)
        voxels = plan_t["voxels"]
        _, clamp = _bound_profile(voxels.shape[-1], self.bound, attack=True)
        clamp = torch.as_tensor(clamp, dtype=voxels.dtype, device=voxels.device)
        alpha = self.rel_step * clamp / max(self.steps, 1)
        delta = torch.zeros_like(voxels)
        with frozen(self.trainer.model):
            for _ in range(self.steps):
                g = self.loss_grad(delta, gt, plan_t)
                delta = torch.clamp(delta + alpha * torch.sign(g), -clamp, clamp)
        m = plan_t["point_mask"][..., None].to(voxels.dtype)
        return dict(plan_t, voxels=voxels + delta * m)


def make_plan_attack(trainer, steps: int = 10, rel_step: float = 2.5) -> PlanAttack:
    """The K-step PGD attack of `trainer`'s model (FGSM: steps=1, rel_step=1.0)."""
    return PlanAttack(trainer, steps, rel_step)
