"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card and no explicit request they raise instead of carrying on silently on
the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` -> the current CUDA device (raises without one); else as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


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
