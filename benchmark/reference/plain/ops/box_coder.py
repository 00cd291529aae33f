"""Delta-XYZWLHR residual box coder (SECOND-style).

Counterpart of robustpointclouds_tpu/ops/box_coder.encode/decode. Geometry
stays in float32.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def encode(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Encode target boxes [..., 7] against anchors [..., 7] into deltas."""
    xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)
    xg, yg, zg, dxg, dyg, dzg, rg = boxes.unbind(-1)
    diag = torch.sqrt(dxa**2 + dya**2) + _EPS
    return torch.stack(
        [
            (xg - xa) / diag,
            (yg - ya) / diag,
            (zg - za) / torch.clamp(dza, min=_EPS),
            torch.log(torch.clamp(dxg, min=_EPS) / torch.clamp(dxa, min=_EPS)),
            torch.log(torch.clamp(dyg, min=_EPS) / torch.clamp(dya, min=_EPS)),
            torch.log(torch.clamp(dzg, min=_EPS) / torch.clamp(dza, min=_EPS)),
            rg - ra,
        ],
        dim=-1,
    )


def decode(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Decode predicted deltas [..., 7] against anchors [..., 7] into boxes."""
    xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)
    tx, ty, tz, tdx, tdy, tdz, tr = deltas.unbind(-1)
    diag = torch.sqrt(dxa**2 + dya**2) + _EPS
    return torch.stack(
        [
            tx * diag + xa,
            ty * diag + ya,
            tz * dza + za,
            torch.exp(torch.clamp(tdx, -10.0, 10.0)) * dxa,
            torch.exp(torch.clamp(tdy, -10.0, 10.0)) * dya,
            torch.exp(torch.clamp(tdz, -10.0, 10.0)) * dza,
            tr + ra,
        ],
        dim=-1,
    )
