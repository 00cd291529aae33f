"""The weights of a run, made from its seed on the device in one draw.

The plain reference's model names every parameter and buffer; the port's
model carries the same names, so one state dict serves both. Initialisation
follows the port's flax-style rule: fan-in normal for sparse convs, dense
convs, transposed convs (fan-in over in * kh * kw) and linears; the focal
prior -4.595 on the class-logit and heatmap biases, other biases 0;
N(0, 0.025) on the adversary's output layer and its bias; BatchNorm the
identity (scale 1, shift 0, running mean 0, running variance 1). A traffic
file may set the class-logit bias itself ("class_logit_bias"): an
evaluation cell serves a model whose scores pass the test threshold, as a
trained detector's do, where the prior would leave every detection below
it."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from .reference.plain.nn.sparse_encoder import SparseConv3d

PRIOR = -4.595
_PRIOR_NAMES = ("conv_cls", "heatmap.1", "cls_head.1")


def _plan(model: nn.Module, prior: float
          ) -> Tuple[List[Tuple[str, torch.Size, float]], Dict[str, float]]:
    """(normal leaves as (name, shape, std), constant leaves as name -> value)."""
    normal: List[Tuple[str, torch.Size, float]] = []
    const: Dict[str, float] = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, SparseConv3d):
            normal.append((pre + "weight", mod.weight.shape, math.sqrt(1.0 / mod.weight[0].numel())))
        elif isinstance(mod, nn.ConvTranspose2d):
            w = mod.weight
            normal.append((pre + "weight", w.shape,
                           math.sqrt(1.0 / (w.shape[0] * w.shape[2] * w.shape[3]))))
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            out_layer = name.endswith("mlp_out")
            std = 0.025 if out_layer else math.sqrt(1.0 / mod.weight[0].numel())
            normal.append((pre + "weight", mod.weight.shape, std))
            if mod.bias is not None:
                if out_layer:
                    normal.append((pre + "bias", mod.bias.shape, 0.025))
                else:
                    const[pre + "bias"] = prior if name.endswith(_PRIOR_NAMES) else 0.0
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            const.update({pre + "weight": 1.0, pre + "bias": 0.0, pre + "running_mean": 0.0,
                          pre + "running_var": 1.0, pre + "num_batches_tracked": 0})
    return normal, const


def make(model: nn.Module, seed: int, device: torch.device,
         prior: float = PRIOR) -> Dict[str, torch.Tensor]:
    """The state dict of `model`'s names, drawn from `seed` on `device`;
    `prior` the class-logit and heatmap bias."""
    normal, const = _plan(model, prior)
    state = model.state_dict()
    missing = set(state) - set(const) - {n for n, _, _ in normal}
    if missing:
        raise ValueError(f"no initialisation rule for {sorted(missing)}")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(int(math.prod(s)) for _, s, _ in normal)
    draw = torch.randn(total, generator=gen, device=device)
    stds = torch.cat([torch.full((int(math.prod(s)),), std, device=device)
                      for _, s, std in normal])
    draw.mul_(stds)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, _ in normal:
        n = int(math.prod(shape))
        out[name] = draw[at:at + n].view(shape)
        at += n
    for name, v in const.items():
        ref = state[name]
        out[name] = torch.full(ref.shape, v, dtype=ref.dtype, device=device)
    return out
