"""The learned adversaries VoxelPerturber and StrongVoxelPerturber (counterpart of robustpointclouds_tpu/nn/perturber.py).

`VoxelPerturber`: an encoder-decoder MLP over per-point features with
sigmoid spatial attention, per-feature std normalisation, a
sensor-error-bounded tanh output and the asymmetric train/attack bound
profiles of the reference (models/adversarial/voxel_perturber.py).
`StrongVoxelPerturber`: the deeper variant of the strong family
(models/adversarial/strong_voxel_perturber.py) with dropout, a bottleneck, a
selectable activation and the momentum / dynamic-scale inputs; it returns
deltas. The masked statistics (the std normalisation and the per-dim
mean/var of the regulariser) go through the masked-stats kernel, and every
MaskedBatchNorm through the fused one (ReLU fused into it).

Parameter names (`mlp_i`, `bn_i`, `mlp_out`, `attn_0`, `attn_1`; the strong
variant's `enc_i`, `enc_bn_i`, `bottleneck`, `bottleneck_bn`, `dec_i`,
`dec_bn_i`, `out`) follow the JAX modules', which tools/convert.py maps one
to one.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import device_constant
from ..core.registry import ADVERSARIES
from ..kernels.masked_stats import masked_stats
from .layers import MaskedBatchNorm

# Run the adversary MLP (Linear/BN/ReLU stack) in bfloat16, as the JAX
# package does by default (RPC_PERT_BF16, on unless set to 0). Parameters,
# BN statistics, the bound math and the regulariser losses stay float32;
# the perturbation deltas are bounded at +-0.2 m, so bf16 on the delta is
# below sensor noise. Tests pin it to False for float32 parity.
PERT_BF16 = os.environ.get("RPC_PERT_BF16", "1") == "1"


def _bound_profile(num_features: int, sensor_error_bound: float,
                   attack: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(scale_bounds, clamp_bounds) per feature, matching the reference.

    KITTI (F=4): train x0.8 overall, spatial x1.3, intensity 0.2 (clamps
    x0.9, x1.2, 0.1); attack x2.5*avg(2.0, 1.5, 1.2), spatial x2,
    intensity 1.5 (clamps x5, x5, 2.0). NuScenes (F=5): bounds = the sensor
    error bound, timestamp channel zeroed.
    """
    e = sensor_error_bound
    scale = np.full(num_features, e, np.float32)
    clamp = np.full(num_features, e, np.float32)
    if num_features == 4:
        if attack:
            avg_boost = (2.0 + 1.5 + 1.2) / 3.0
            scale *= 2.5 * avg_boost
            scale[:3] *= 2.0
            scale[3] = 1.5
            clamp *= 5.0
            clamp[:3] *= 5.0
            clamp[3] = 2.0
        else:
            scale *= 0.8
            scale[:3] *= 1.3
            scale[3] = 0.2
            clamp *= 0.9
            clamp[:3] *= 1.2
            clamp[3] = 0.1
    elif num_features > 4:
        scale[4:] = 0.0
        clamp[4:] = 0.0
    return scale, clamp


def perturbation_losses(perturbations: torch.Tensor, features: torch.Tensor,
                        mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The paper's regulariser terms over valid rows (reference voxel_perturber.py:267-317)."""
    m = mask.to(perturbations.dtype)
    count = torch.clamp(m.sum(), min=1.0)
    row_norm = torch.sqrt((perturbations**2).sum(1) + 1e-12)
    l2_norm = (row_norm * m).sum() / count
    ref_norm = (torch.sqrt((features**2).sum(1) + 1e-12) * m).sum() / count
    l2_percentage = l2_norm / (ref_norm + 1e-8) * 100.0

    nf = perturbations.shape[1]
    if nf >= 4:
        intensity = (perturbations[:, 3].abs() * m).sum() / count
    else:
        intensity = perturbations.new_zeros(())
    mean_per_dim, var_per_dim, _ = masked_stats(perturbations, mask)
    bias = mean_per_dim.abs().mean()
    std_per_dim = torch.sqrt(var_per_dim + 1e-12)
    imbalance = std_per_dim.std(unbiased=False)
    abs_pert = perturbations.abs() * m[:, None]
    mean_abs = abs_pert.sum() / (count * nf)
    mean_all = (perturbations * m[:, None]).sum() / (count * nf)
    std_all = torch.sqrt(
        (((perturbations - mean_all) * m[:, None]) ** 2).sum() / (count * nf) + 1e-12
    )
    return {
        "l2_norm": l2_norm,
        "l2_percentage": l2_percentage,
        "intensity_loss": intensity,
        "bias_loss": bias,
        "imbalance_loss": imbalance,
        "max_perturbation": abs_pert.max(),
        "mean_perturbation": mean_abs,
        "std_perturbation": std_all,
    }


@ADVERSARIES.register_module()
class VoxelPerturber(nn.Module):
    """Bounded learned perturbations on raw point features [N, F]."""

    def __init__(self, num_features: int = 4, sensor_error_bound: float = 0.2,
                 use_spatial_attention: bool = True,
                 hidden_channels: Sequence[int] = (8, 16, 32)):
        super().__init__()
        self.num_features = num_features
        self.sensor_error_bound = sensor_error_bound
        self.use_spatial_attention = use_spatial_attention
        chans = list(hidden_channels)
        widths = chans + chans[-2::-1]  # encoder + mirrored decoder
        cin = num_features
        for i, c in enumerate(widths):
            self.add_module(f"mlp_{i}", nn.Linear(cin, c))
            self.add_module(f"bn_{i}", MaskedBatchNorm(c))
            cin = c
        self.num_layers = len(widths)
        self.mlp_out = nn.Linear(cin, num_features)
        if use_spatial_attention:
            self.attn_0 = nn.Linear(num_features, max(num_features // 2, 1))
            self.attn_1 = nn.Linear(max(num_features // 2, 1), 1)

    @staticmethod
    def _dense(layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        return F.linear(h, layer.weight.to(h.dtype), layer.bias.to(h.dtype))

    def forward(self, features: torch.Tensor, mask: torch.Tensor,
                attack: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """features [N, F] (padding rows arbitrary), mask [N] -> (perturbed [N, F], losses).

        `self.training` selects batch-norm mode; `attack` selects the
        aggressive evaluation-attack bound profile over the training one.
        """
        f = self.num_features
        if features.shape[-1] != f:
            raise ValueError(f"expected {f} features, got {tuple(features.shape)}")
        # per-feature std normalisation over valid rows, clamp +-10
        _, var, _ = masked_stats(features, mask)
        std = torch.sqrt(var + 1e-6)
        x = torch.clamp(features / (std + 1e-6), -10.0, 10.0)
        x = torch.where(mask[:, None], x, torch.zeros_like(x))

        mlp_dtype = torch.bfloat16 if PERT_BF16 else torch.float32
        h = x.to(mlp_dtype)
        for i in range(self.num_layers):
            h = self._dense(getattr(self, f"mlp_{i}"), h)
            # ReLU after the cast to the MLP's type, fused: rounding commutes with it
            h = getattr(self, f"bn_{i}")(h, mask, relu=True, out_dtype=mlp_dtype)
        raw = torch.tanh(self._dense(self.mlp_out, h).float())

        if self.use_spatial_attention:
            a = torch.relu(self._dense(self.attn_0, x.to(mlp_dtype)))
            a = self._dense(self.attn_1, a)
            raw = raw * torch.sigmoid(a.float())

        scale_b, clamp_b = _bound_profile(f, self.sensor_error_bound, attack)
        scale_t = device_constant(scale_b.tolist(), torch.float32, raw.device)
        clamp_t = device_constant(clamp_b.tolist(), torch.float32, raw.device)
        pert = torch.clamp(raw * scale_t, -clamp_t, clamp_t)
        # branch-free NaN guard == the reference's fall-back-to-identity
        pert = torch.nan_to_num(pert, nan=0.0, posinf=0.0, neginf=0.0)
        pert = torch.where(mask[:, None], pert, torch.zeros_like(pert))
        return features + pert, perturbation_losses(pert, features, mask)


def _dropout(h: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout as flax's: a unit is kept with probability 1 - rate
    (a uniform draw below it, from `generator` on its own device) and scaled
    by 1 / (1 - rate); dropped units are 0."""
    keep = 1.0 - rate
    kept = torch.rand(h.shape, generator=generator, device=generator.device) < keep
    return torch.where(kept.to(h.device), h / keep, torch.zeros_like(h))


@ADVERSARIES.register_module()
class StrongVoxelPerturber(nn.Module):
    """Deeper adversary with dropout, a bottleneck and dynamic-scaling hooks.

    The epoch / effectiveness / magnitude scaling lives in the train loop
    (host side, `strong_dynamic_scale`); the module takes the combined
    `scale_factor`. Momentum over the previous step's perturbations is
    carried by the caller ([N, F], `last_perturbations`).
    """

    def __init__(self, num_features: int = 4, sensor_error_bound: float = 0.18,
                 use_spatial_attention: bool = True,
                 hidden_channels: Sequence[int] = (64, 128, 256, 128),
                 dropout_rate: float = 0.1, activation: str = "ReLU",
                 use_batch_norm: bool = True, momentum_alpha: float = 0.9):
        super().__init__()
        self.num_features = num_features
        self.sensor_error_bound = sensor_error_bound
        self.use_spatial_attention = use_spatial_attention
        self.dropout_rate = dropout_rate
        self.activation = activation
        self.use_batch_norm = use_batch_norm
        self.momentum_alpha = momentum_alpha
        chans = list(hidden_channels)
        self.depth = len(chans)
        cin = num_features
        for i, c in enumerate(chans):
            self.add_module(f"enc_{i}", nn.Linear(cin, c))
            if use_batch_norm:
                self.add_module(f"enc_bn_{i}", MaskedBatchNorm(c))
            cin = c
        width = max(chans[-1] // 2, 16)
        self.bottleneck = nn.Linear(cin, width)
        self.bottleneck_bn = MaskedBatchNorm(width) if use_batch_norm else None
        cin = width
        for i, c in enumerate(reversed(chans)):
            self.add_module(f"dec_{i}", nn.Linear(cin, c))
            if i < self.depth - 1 and use_batch_norm:
                self.add_module(f"dec_bn_{i}", MaskedBatchNorm(c))
            cin = c
        self.out = nn.Linear(cin, num_features)
        if use_spatial_attention:
            ah = max(num_features // 2, 8)
            self.attn_0 = nn.Linear(num_features, ah)
            self.attn_1 = nn.Linear(ah, 1)

    def _act(self, h: torch.Tensor) -> torch.Tensor:
        if self.activation == "LeakyReLU":
            return F.leaky_relu(h, 0.2)
        if self.activation == "ELU":
            return F.elu(h)
        return torch.relu(h)

    def _norm_act(self, name: str, h: torch.Tensor, mask: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
        """BatchNorm `name` (when the module has it) and the activation; ReLU
        fuses into the BatchNorm kernel (rounding to `dtype` commutes with it)."""
        bn = getattr(self, name, None) if self.use_batch_norm else None
        if bn is None:
            return self._act(h)
        if self.activation in ("LeakyReLU", "ELU"):
            return self._act(bn(h, mask, out_dtype=dtype))
        return bn(h, mask, relu=True, out_dtype=dtype)

    def forward(self, features: torch.Tensor, mask: torch.Tensor,
                scale_factor: Union[float, torch.Tensor] = 1.0,
                last_perturbations: Optional[torch.Tensor] = None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """features [N, F], mask [N] -> (perturbation deltas [N, F], losses).

        `self.training` selects batch-norm mode and the training bound
        profile (eval: the attack one). Dropout runs unless `deterministic`,
        with masks drawn from `generator`, which it then needs."""
        f = self.num_features
        if features.shape[-1] != f:
            raise ValueError(f"expected {f} features, got {tuple(features.shape)}")
        drop = not deterministic and self.dropout_rate > 0
        if drop and generator is None:
            raise ValueError("StrongVoxelPerturber: dropout needs an explicit torch.Generator")
        mean, var, _ = masked_stats(features, mask)
        x = torch.clamp((features - mean) / torch.sqrt(var + 1e-6), -5.0, 5.0)
        x = torch.where(mask[:, None], x, torch.zeros_like(x))

        mlp_dtype = torch.bfloat16 if PERT_BF16 else torch.float32
        dense = VoxelPerturber._dense
        h = x.to(mlp_dtype)
        rate = self.dropout_rate
        for i in range(self.depth):
            h = self._norm_act(f"enc_bn_{i}", dense(getattr(self, f"enc_{i}"), h), mask,
                               mlp_dtype)
            if drop and i < self.depth - 1:
                h = _dropout(h, rate, generator)
        h = self._norm_act("bottleneck_bn", dense(self.bottleneck, h), mask, mlp_dtype)
        if drop:
            h = _dropout(h, rate * 1.5, generator)
        for i in range(self.depth):
            h = dense(getattr(self, f"dec_{i}"), h)
            if i < self.depth - 1:
                h = self._norm_act(f"dec_bn_{i}", h, mask, mlp_dtype)
                if drop:
                    h = _dropout(h, rate * 0.5, generator)
        raw = torch.tanh(dense(self.out, h).float())

        if self.use_spatial_attention:
            a = self._act(dense(self.attn_0, x.to(mlp_dtype)))
            raw = raw * torch.sigmoid(dense(self.attn_1, a).float())
        if last_perturbations is not None:
            raw = raw + 0.1 * (self.momentum_alpha * last_perturbations.detach())

        bounds = torch.as_tensor(_strong_bounds(f, self.sensor_error_bound, self.training),
                                 device=raw.device)
        pert = raw * bounds * scale_factor
        pert = torch.nan_to_num(pert, nan=0.0, posinf=0.0, neginf=0.0)
        pert = torch.where(mask[:, None], pert, torch.zeros_like(pert))
        return pert, perturbation_losses(pert, features, mask)


def _strong_bounds(num_features: int, sensor_error_bound: float, train: bool) -> np.ndarray:
    """The strong adversary's per-feature bounds (reference
    strong_voxel_perturber.py): KITTI (F=4) x1.2 / x2.0 overall, spatial
    x1.5 / x2.5, intensity 0.8 / 1.5 (train / eval), all x the class boost
    avg(2.5, 1.8, 1.2); other widths the sensor error bound."""
    bounds = np.full(num_features, sensor_error_bound, np.float32)
    if num_features == 4:
        class_boost = (2.5 + 1.8 + 1.2) / 3.0
        mult, spatial, intensity = (1.2, 1.5, 0.8) if train else (2.0, 2.5, 1.5)
        bounds *= mult
        bounds[:3] *= spatial
        bounds[3] = intensity
        bounds *= class_boost
    return bounds


def strong_dynamic_scale(epoch: float, effectiveness_recent: Optional[float],
                         magnitude_recent: Optional[float], jitter: float = 0.0,
                         max_scale: float = 5.0) -> float:
    """Host-side dynamic scaling (reference strong_voxel_perturber.py:214-254):
    epoch_scale = 1 + 0.1 * epoch; weak-attack boost x1.5 / x2; small-
    perturbation boost x1.8; capped at max_scale, then the multiplicative
    jitter (at least x0.8)."""
    epoch_scale = 1.0 + 0.1 * epoch
    if effectiveness_recent is None:
        eff = 1.0
    elif effectiveness_recent < 0.1:
        eff = 2.0
    elif effectiveness_recent < 0.3:
        eff = 1.5
    else:
        eff = 1.0
    mag = 1.8 if (magnitude_recent is not None and magnitude_recent < 0.1) else 1.0
    scale = min(epoch_scale * eff * mag, max_scale)
    return scale * max(1.0 + jitter, 0.8)
