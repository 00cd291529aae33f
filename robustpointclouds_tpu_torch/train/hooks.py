"""Failure-detection hooks: the NaN escalation ladder and adversary recovery.

Counterpart of robustpointclouds_tpu/train/hooks.py (the reference's
NaNDetectionHook, custom_hook.py:77-151, and the perturber's weight reset,
voxel_perturber.py:477-497). The per-iteration mitigations run as tensor
ops on the device inside the train step (`device_nan_ladder`, called from
train/loop.py), so no step waits for the host:

  * every NaN step gives a zero parameter update (loss zeroed, gradients
    sanitised, update scaled by 0);
  * LR x0.1 exactly once when the total of NaN steps reaches 10;
  * adversarial training disabled once the total exceeds 100.

Only what a step cannot do stays on the host (`NaNLadder`, consulted at
logging boundaries): re-initialising the adversary's weights and stopping
the run after 50 consecutive NaN steps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import nn


def device_nan_ladder(nan_count: torch.Tensor, nan_step: torch.Tensor, lr_scale: torch.Tensor,
                      adversary_enabled: torch.Tensor, max_nan_count: int = 10,
                      disable_adversary_after_total: int = 100
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total NaN steps before this one (int32), this step's 0/1 (int32),
    ladder LR multiplier, 1.0/0.0 kill switch) -> (new total, new LR
    multiplier, new kill switch) (reference custom_hook.py:119-142)."""
    new_total = nan_count + nan_step
    crossed = (nan_count < max_nan_count) & (new_total >= max_nan_count)
    new_lr_scale = torch.where(crossed, lr_scale * 0.1, lr_scale)
    new_enabled = adversary_enabled * (new_total <= disable_adversary_after_total).to(torch.float32)
    return new_total, new_lr_scale, new_enabled


@dataclasses.dataclass
class NaNLadder:
    """Host-side remainder of the ladder: adversary re-init + hard stop."""

    max_nan_count: int = 10
    stop_after_consecutive: int = 50
    should_stop: bool = False
    reinit_done: bool = False

    def update(self, state, adversary_reinit_fn: Optional[Callable[[], None]] = None):
        """Read the device counters of `state` (train/loop.TrainState); call
        `adversary_reinit_fn()` once when the NaN total reaches max_nan_count."""
        total = int(state.nan_count)
        consecutive = int(state.consecutive_nan)
        if consecutive >= self.stop_after_consecutive:
            self.should_stop = True
            return state
        if total >= self.max_nan_count and not self.reinit_done:
            self.reinit_done = True
            if adversary_reinit_fn is not None:
                adversary_reinit_fn()
        return state


@torch.no_grad()
def reinit_adversary_params(adversary: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights for the adversary (NaN recovery), in place: xavier-uniform
    x 0.001 for matrices, zeros for vectors, as the JAX version draws them
    (from an explicit generator, so not the same numbers)."""
    for p in adversary.parameters():
        if p.dim() >= 2:
            fan_out, fan_in = p.shape[0], p[0].numel()
            limit = (6.0 / (fan_in + fan_out)) ** 0.5
            u = torch.rand(p.shape, generator=generator, dtype=torch.float32) * 2.0 - 1.0
            p.copy_((u * limit * 0.001).to(p.device, p.dtype))
        else:
            p.zero_()
