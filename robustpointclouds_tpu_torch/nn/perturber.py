"""The learned adversary VoxelPerturber (counterpart of robustpointclouds_tpu/nn/perturber.py).

An encoder-decoder MLP over per-point features with sigmoid spatial
attention, per-feature std normalisation, a sensor-error-bounded tanh output
and the asymmetric train/attack bound profiles of the reference
(models/adversarial/voxel_perturber.py). The masked statistics (the std
normalisation and the per-dim mean/var of the regulariser) go through the
masked-stats kernel.

Parameter names (`mlp_i`, `bn_i`, `mlp_out`, `attn_0`, `attn_1`) follow the
JAX module's, which tools/convert.py maps one to one.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.masked_stats import masked_stats
from .layers import MaskedBatchNorm

# Run the adversary MLP (Linear/BN/ReLU stack) in bfloat16, as the JAX
# package does by default. Parameters, BN statistics, the bound math and the
# regulariser losses stay float32; the perturbation deltas are bounded at
# +-0.2 m, so bf16 on the delta is below sensor noise. Tests pin it to False
# for float32 parity.
PERT_BF16 = True


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
        scale_t = torch.as_tensor(scale_b, device=raw.device)
        clamp_t = torch.as_tensor(clamp_b, device=raw.device)
        pert = torch.clamp(raw * scale_t, -clamp_t, clamp_t)
        # branch-free NaN guard == the reference's fall-back-to-identity
        pert = torch.nan_to_num(pert, nan=0.0, posinf=0.0, neginf=0.0)
        pert = torch.where(mask[:, None], pert, torch.zeros_like(pert))
        return features + pert, perturbation_losses(pert, features, mask)
