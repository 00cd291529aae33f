"""The trainer's two optimizer chains in plain torch (float32): Adam with the
whole-tree global-norm clip, weight decay and the warm-up / cosine schedule,
the adversary's chain with its per-element clip first, a NaN step leaving the
parameters where they were."""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch


def lr_schedule(cfg: Dict) -> Callable[[int], float]:
    """Linear warm-up from warmup_start_factor * lr over warmup_iters updates,
    then cosine to eta_min_factor * lr over the rest of training."""
    total = cfg["max_epochs"] * cfg["steps_per_epoch"]
    lr = cfg["learning_rate"]
    start = lr * cfg["warmup_start_factor"]
    warm = cfg["warmup_iters"]
    decay = max(total - warm, 1)

    def schedule(count: int) -> float:
        if count < warm:
            frac = 1.0 - min(max(count, 0), warm) / warm
            return (start - lr) * frac + lr
        t = min(count - warm, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return lr * ((1.0 - cfg["eta_min_factor"]) * cosine + cfg["eta_min_factor"])

    return schedule


def _global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((t.double() ** 2).sum() for t in tensors)).float()


class TwoChains:
    """State and update of the detector's and the adversary's Adam chains;
    a parameter belongs to the adversary's when its name starts with
    "adversary."."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict):
        self.cfg = cfg
        self.schedule = lr_schedule(cfg)
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             is_nan: bool) -> None:
        cfg = self.cfg
        b1, b2 = cfg["betas"]
        clip_v = cfg["adversary_grad_clip_value"]
        names = list(params)
        g_det = [grads[k] for k in names]
        g_adv = [g.clamp(-clip_v, clip_v) for g in g_det]
        norms = {False: _global_norm(g_det), True: _global_norm(g_adv)}
        n = self.count + 1
        for k, g_d, g_a in zip(names, g_det, g_adv):
            adv = k.startswith("adversary.")
            g = g_a if adv else g_d
            norm = norms[adv]
            factor = torch.where(norm < cfg["grad_clip_norm"], torch.ones_like(norm),
                                 cfg["grad_clip_norm"] / norm)
            g = g * factor
            self.mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            den = torch.sqrt(self.nu[k] / (1.0 - b2 ** n)) + 1e-8
            upd = (self.mu[k] / (1.0 - b1 ** n)) / den + cfg["weight_decay"] * params[k]
            mult = cfg["adversary_lr_mult"] if adv else 1.0
            upd = torch.nan_to_num(upd * (-self.schedule(self.count) * mult))
            if not is_nan:
                params[k].add_(upd)
        self.count += 1
