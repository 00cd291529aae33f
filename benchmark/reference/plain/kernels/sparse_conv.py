"""The sparse conv as a plain gather and matmul, differentiable by autograd."""
from __future__ import annotations

import torch

from .. import precision

_ZERO_ROWS = 1024  # missing neighbours spread over this many zero rows


def sparse_conv_train(feats: torch.Tensor, weight: torch.Tensor, idx: torch.Tensor,
                      bwd_idx: torch.Tensor = None, mirror: bool = False) -> torch.Tensor:
    """out[m] = sum_k feats[idx[m, k]] @ W_k, a missing neighbour (index N or
    more) a zero row. weight: [K*Cin, Cout]. `bwd_idx` and `mirror` are
    unused: the backward is autograd's (index_select's, an index_add). The
    missing neighbours read zero rows spread over _ZERO_ROWS, so that the
    backward's adds do not all meet on one row."""
    x = precision.body(feats)
    w = precision.body(weight)
    n, c = x.shape
    flat = idx.reshape(-1).long()
    spread = n + torch.arange(flat.numel(), device=flat.device) % _ZERO_ROWS
    flat = torch.where(flat < n, flat, spread)
    x_pad = torch.cat([x, x.new_zeros(_ZERO_ROWS, c)], 0)
    col = x_pad.index_select(0, flat).reshape(idx.shape[0], idx.shape[1] * c)
    return precision.body_out(col @ w)
