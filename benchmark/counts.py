"""What the work of a step needs, counted from the plain reference's own
plan and shapes: each sparse conv's neighbour hits and rows, each masked
batch norm's and masked statistic's valid rows, each dense product's shape.

`record(ref_model, run)` runs `run()` (a reference forward) with hooks on
the reference model's modules and returns the launches it saw. Padding
never counts: a sparse conv's rows are those with a neighbour hit, a batch
norm's rows those its mask keeps, the adversary's linears' rows the valid
points."""
from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch import nn

from .reference.plain.nn.anchor_head import Anchor3DHead
from .reference.plain.nn.layers import MaskedBatchNorm
from .reference.plain.nn.perturber import VoxelPerturber
from .reference.plain.nn.sparse_encoder import SparseConv3d


def conv_record(idx: torch.Tensor, n_in: int, cin: int, cout: int) -> Dict:
    """A sparse conv's counts from its forward index [M, K] over n_in input
    rows (an entry n_in or more is a missing neighbour)."""
    hit = idx.long() < n_in
    rows_in = int(torch.unique(idx.long()[hit]).numel())
    return {"kind": "sparse_conv", "hits": int(hit.sum()), "rows_out": int(hit.any(1).sum()),
            "rows_in": rows_in, "taps": int(idx.shape[1]), "cin": cin, "cout": cout}


def record(model: nn.Module, run: Callable[[], object]) -> List[Dict]:
    """The launches of one reference forward, in order."""
    out: List[Dict] = []
    hooks = []
    names = {m: n for n, m in model.named_modules()}

    def on_sparse(mod, args, _):
        feats, idx = args[0], args[1]
        out.append(conv_record(idx, feats.shape[0], mod.weight.shape[-1], mod.weight.shape[0]))

    def on_bn(mod, args, _):
        x, mask = args[0], args[1]
        out.append({"kind": "masked_bn", "rows": int(mask.sum()), "c": int(x.shape[1]),
                    "adversary": names[mod].startswith("adversary.")})

    def on_perturber(mod, args, _):
        # its linears run through F.linear over every slot; the count takes the valid ones
        mask = args[1]
        out.append({"kind": "perturber", "rows": int(mask.sum()), "slots": int(mask.numel()),
                    "c": int(args[0].shape[1]),
                    "linear_macs": sum(m.in_features * m.out_features for m in mod.modules()
                                       if isinstance(m, nn.Linear))})

    def on_anchor_head(mod, args, _):
        # its 1x1 convs run through F.conv2d
        x = args[0]
        cout = sum(c.out_channels for c in (mod.conv_cls, mod.conv_reg, mod.conv_dir_cls))
        out.append({"kind": "dense", "macs": x.numel() * cout})

    def on_dense(mod, args, y):
        x = args[0]
        if isinstance(mod, nn.ConvTranspose2d):
            kh, kw = mod.kernel_size
            out.append({"kind": "dense", "macs": x.numel() * mod.out_channels * kh * kw})
        else:
            kh, kw = mod.kernel_size
            out.append({"kind": "dense",
                        "macs": y.numel() * (mod.in_channels // mod.groups) * kh * kw})

    heads = tuple(n + "." for m, n in names.items() if isinstance(m, Anchor3DHead))
    for m in model.modules():
        if isinstance(m, SparseConv3d):
            hooks.append(m.register_forward_hook(on_sparse))
        elif isinstance(m, MaskedBatchNorm):
            hooks.append(m.register_forward_hook(on_bn))
        elif isinstance(m, VoxelPerturber):
            hooks.append(m.register_forward_hook(on_perturber))
        elif isinstance(m, Anchor3DHead):
            hooks.append(m.register_forward_hook(on_anchor_head))
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and not names[m].startswith(heads):
            hooks.append(m.register_forward_hook(on_dense))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return out


def forward_flops(records: List[Dict]) -> float:
    """2 x the multiply-adds of one forward: sparse convs by hits, dense
    convs and transposed convs by their shapes, the adversary's linears over
    the valid points only."""
    macs = 0.0
    for r in records:
        if r["kind"] == "sparse_conv":
            macs += r["hits"] * r["cin"] * r["cout"]
        elif r["kind"] == "dense":
            macs += r["macs"]
        elif r["kind"] == "perturber":
            macs += r["rows"] * r["linear_macs"]
    return 2.0 * macs
