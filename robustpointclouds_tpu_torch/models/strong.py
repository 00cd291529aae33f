"""StrongAdversarialVoxelNet: post-encoder perturbations with attack dynamics (counterpart of robustpointclouds_tpu/models/strong.py).

The reference variant (models/detectors/strong_adversarial_voxelnet.py)
differs from AdversarialVoxelNet in four ways, all kept here:
  * it perturbs the VFE output features [B*V, 4] (post voxel-encoder, pre
    middle-encoder, in the plan's `order`) rather than the raw points;
  * StrongVoxelPerturber, with momentum over the previous step's
    perturbations, carried as explicit state by the train loop;
  * dynamic scaling: epoch growth x effectiveness boost x the curriculum
    min(1 + iter/10000, 2), computed by the train loop
    (nn/perturber.strong_dynamic_scale) and passed in as `scale_factor`;
  * anti-adaptation: with probability `anti_adaptation_prob` the detector's
    losses are scaled x0.1 for the step (train/strong_loop.py).

The model runs on the SECOND plan of `cfg.base` (the strong variant
perturbs post-VFE features, so the sparse structure does not depend on the
perturbation): the host's, or with `plan=None` the one AdversarialVoxelNet
builds inline on the points' device. The
reference's `class_attack_weights` / `post_encoding_noise_scales` fields are
configured but never applied; they are accepted here for config parity and
likewise unused.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..core.registry import MODELS
from ..nn.perturber import StrongVoxelPerturber
from ..ops.grad import grad_scale
from .voxelnet import AdversarialVoxelNet, VoxelNetConfig


class StrongVoxelNetConfig(NamedTuple):
    base: VoxelNetConfig = VoxelNetConfig(adversary=None)
    perturber: Dict[str, Any] = {
        "sensor_error_bound": 0.18,
        "hidden_channels": (64, 128, 256, 128),
        "dropout_rate": 0.1,
        "activation": "ReLU",
        "use_batch_norm": True,
    }
    adversarial_loss_weight: float = 0.1
    momentum_loss_weight: float = 0.1
    anti_adaptation_prob: float = 0.1
    max_scaling: float = 5.0
    # accepted but unused (reference parity, strong_adversarial_voxelnet.py:82-85)
    class_attack_weights: Optional[Dict[str, float]] = None
    post_encoding_noise_scales: Optional[Dict[str, float]] = None


class StrongOutputs(NamedTuple):
    cls_scores: torch.Tensor
    bbox_preds: torch.Tensor
    dir_preds: torch.Tensor
    adv_aux: Dict[str, torch.Tensor]
    perturbations: torch.Tensor  # [B*V, 4], for the momentum carry


_ADV_AUX_KEYS = ("l2_norm", "l2_percentage", "intensity_loss", "bias_loss", "imbalance_loss",
                 "max_perturbation")


@MODELS.register_module()
class StrongAdversarialVoxelNet(AdversarialVoxelNet):
    """The SECOND body of `cfg.base` (AdversarialVoxelNet's encoder, backbone,
    FPN and Anchor3DHead) with the StrongVoxelPerturber on its post-VFE
    features."""

    def __init__(self, cfg: StrongVoxelNetConfig = StrongVoxelNetConfig()):
        super().__init__(cfg.base._replace(adversary=None))
        self.cfg = cfg
        self.adversary = StrongVoxelPerturber(
            num_features=4, **{k: tuple(v) if isinstance(v, list) else v
                               for k, v in cfg.perturber.items()})

    def forward(self, points: Optional[torch.Tensor], points_mask: Optional[torch.Tensor],
                train: bool, scale_factor: Union[float, torch.Tensor] = 1.0,
                last_perturbations: Optional[torch.Tensor] = None,
                adv_grad_scale: Union[float, torch.Tensor] = -1.0,
                apply_perturbations: bool = True, plan: Optional[Dict[str, Any]] = None,
                generator: Optional[torch.Generator] = None) -> StrongOutputs:
        """Forward on a SECOND host plan (models/voxelnet.plan_to_device;
        points/points_mask are then not read and may be None), or with
        plan=None on the plan built inline from the points on their device.

        `train` sets the module's mode (BatchNorm batch statistics, the
        adversary's training bound profile and dropout, whose masks come
        from `generator`). The perturbation deltas reach the encoder through
        `grad_scale(., adv_grad_scale)`; `apply_perturbations=False` is the
        clean forward."""
        plan = self._plan(points, points_mask, plan)
        grid = self._grid(plan, train)
        feats = self._vfe(plan["voxels"], plan)
        zero = feats.new_zeros(())
        adv_aux = {k: zero for k in _ADV_AUX_KEYS}
        pert = torch.zeros_like(feats)
        if apply_perturbations:
            pert, adv_aux = self.adversary(feats, grid.mask, scale_factor, last_perturbations,
                                           deterministic=not train, generator=generator)
            feats = feats + grad_scale(pert, adv_grad_scale)
        return StrongOutputs(*self._detect(feats, grid, plan), adv_aux, pert)


def strong_adversary_terms(adv_aux: Dict[str, torch.Tensor], perturbations: torch.Tensor,
                           last_perturbations: Optional[torch.Tensor],
                           momentum_loss_weight: float = 0.1
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Adversary-only terms: the momentum-consistency bonus (the reference
    adds 0.1 * momentum similarity to sustain the attack's direction)."""
    if last_perturbations is None:
        momentum_term = perturbations.new_zeros(())
    else:
        momentum_term = -(perturbations * last_perturbations.detach()).mean()
    total = momentum_loss_weight * momentum_term
    logs = {"loss_momentum": momentum_term,
            "perturbation_l2_norm": adv_aux["l2_norm"].detach()}
    return total, logs
