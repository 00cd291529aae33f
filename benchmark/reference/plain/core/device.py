"""Constants on a device, made once."""
from __future__ import annotations

from typing import Dict, Sequence, Union

import torch

_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def device_constant(values: Sequence, dtype: torch.dtype,
                    device: Union[str, torch.device]) -> torch.Tensor:
    """The 1-D tensor of `values` on `device`, made once per (values, dtype,
    device) and shared after: a tensor built from host values on the card is
    a host-to-device copy that waits for the card, so building it in every
    step would add a host sync each time. Callers must not write to it.
    While torch.compile or torch.export traces, it is made anew and not
    kept: a traced constant is the graph's, and a tensor made under
    tracing is a fake one."""
    key = (tuple(values), dtype, torch.device(device))
    if torch.compiler.is_compiling():
        return torch.tensor(key[0], dtype=dtype, device=key[2])
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(key[0], dtype=dtype, device=key[2])
    return t
