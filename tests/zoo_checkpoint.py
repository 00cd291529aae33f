"""mmdet3d-keyed zoo state dicts built from a seed, for the warm-start tests.

No zoo file ships with the repository, so the tests and chip_smoke.py build
one with the shapes of a port model: the port's keys with the zoo
converter's renames reversed (the DCN head's `feature_adapt_*.dcn.` ->
`feature_adapt_*.`, its adaptation BatchNorm dropped, as mmdet3d has none),
the adversary left out, weights drawn with a 1/sqrt(fan-in) scale, BatchNorm
affine maps near the identity, positive running variances and a
num_batches_tracked per BatchNorm. Imports torch and numpy only.
"""
from typing import Dict, Iterable, Mapping

import numpy as np
import torch

_DCN = (".feature_adapt_cls.", ".feature_adapt_reg.")


def fake_zoo_state_dict(model_sd: Mapping[str, torch.Tensor], seed: int,
                        spconv1: Iterable[str] = ()) -> Dict[str, np.ndarray]:
    """An mmdet3d state dict for a model of `model_sd`'s shapes; the sparse
    weights named in `spconv1` in spconv1's (kz, ky, kx, in, out) layout."""
    rng = np.random.RandomState(seed)
    spconv1 = set(spconv1)
    out: Dict[str, np.ndarray] = {}
    for key, t in model_sd.items():
        if key.startswith("adversary.") or any(f"{a}bn." in key for a in _DCN):
            continue
        for a in _DCN:
            key = key.replace(f"{a}dcn.", a)
        shape = tuple(t.shape)
        if key.endswith("num_batches_tracked"):
            v = np.asarray(1000, np.int64)
        elif key.endswith("running_var"):
            v = 0.5 + rng.rand(*shape)
        elif key.endswith("running_mean") or (len(shape) == 1 and key.endswith("bias")):
            v = 0.1 * rng.randn(*shape)
        elif len(shape) == 1:  # a BatchNorm's weight
            v = 0.5 + rng.rand(*shape)
        else:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        v = np.asarray(v, np.int64 if key.endswith("num_batches_tracked") else np.float32)
        if key in spconv1:
            v = np.ascontiguousarray(v.transpose(1, 2, 3, 4, 0))
        out[key] = v
    return out


def save_pth(sd: Mapping[str, np.ndarray], path: str) -> str:
    """Write `sd` as mmdet3d does: {"state_dict": {key: tensor}, "meta": ...}."""
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "meta": {"mmdet3d_version": "1.4.0"}}, path)
    return path
