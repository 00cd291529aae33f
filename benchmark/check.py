"""The numbers that decide `correct`, each a widest gap between what the
timed path produced and what the plain reference works out again from the
same inputs and weights."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> Dict[str, float]:
    """Per leaf in `keys`: |prog - ref| / max(ref, the median leaf's ref)."""
    if not keys:
        return {}
    vals = sorted(ref[k] for k in keys)
    median = vals[len(vals) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys}


def _median(v: List[float]) -> float:
    v = sorted(v)
    return v[len(v) // 2] if v else 0.0


def train_leaf_gaps(prog: Dict, ref: Dict) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(first-gradient gaps, change gaps) leaf by leaf. The change leaves
    out the leaves whose reference gradient is under a thousandth of the
    median leaf's: they move by round-off."""
    keys = sorted(ref["grad"])
    median = _median([ref["grad"][k] for k in keys])
    moved = [k for k in keys if ref["grad"][k] >= 1e-3 * median]
    return (_leaf_gaps(prog["grad"], ref["grad"], keys),
            _leaf_gaps(prog["change"], ref["change"], moved))


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """loss_gap: the widest relative gap of the three steps' detection
    losses, loss1_gap the first step's; grad_gap: the widest gap of the
    first gradient's norm leaf by leaf, as the optimizer got it (over the
    larger of the leaf's and the median leaf's reference norm),
    grad_gap_median the median leaf's; change_gap, change_gap_median: the
    same of each parameter's change over the three steps; adversary_gap:
    the widest relative gap of the first step's adversary terms (the
    perturbation's L2 norm, ...: reference/train.ADVERSARY_LOGS); head_gap:
    the first step's head outputs (head_gap below)."""
    steps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"])]
    grad, change = train_leaf_gaps(prog, ref)
    adv = [abs(prog["adversary"][k] - r) / max(abs(r), 1e-30)
           for k, r in ref["adversary"].items()]
    return {"loss_gap": max(steps), "loss1_gap": steps[0], "adversary_gap": max(adv),
            "grad_gap": max(grad.values()), "grad_gap_median": _median(list(grad.values())),
            "change_gap": max(change.values()) if change else 0.0,
            "change_gap_median": _median(list(change.values())),
            "head_gap": head_gap(prog["heads"], ref["heads"])}


MISMATCH = 1e9  # the gap of outputs of another shape than the reference's


def head_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """The widest gap of any head output, over that output's RMS in the reference."""
    out = 0.0
    for k, r in ref.items():
        if k not in prog or prog[k].shape != r.shape:
            return MISMATCH
        p = prog[k].float()
        r = r.float()
        rms = torch.sqrt((r * r).mean()).clamp(min=1e-30)
        out = max(out, float((p - r).abs().max() / rms))
    return out


def decode_gap(prog: Tuple[torch.Tensor, ...], ref: Tuple[torch.Tensor, ...]) -> float:
    """The widest gap between two decodes (boxes, scores, labels, valid):
    1.0 where a slot's validity or a valid slot's label differs, else the
    largest difference of a valid slot's score or box value."""
    pb, ps, pl, pv = prog
    rb, rs, rl, rv = ref
    if pb.shape != rb.shape or pv.shape != rv.shape:
        return MISMATCH
    if not torch.equal(pv.bool(), rv.bool()):
        return 1.0
    v = rv.bool()
    if not v.any():
        return 0.0
    if not torch.equal(pl[v].long(), rl[v].long()):
        return 1.0
    gap = (ps[v].float() - rs[v].float()).abs().max()
    return float(max(gap, (pb[v].float() - rb[v].float()).abs().max()))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a number that is not finite fails)."""
    return all(n == n and n <= limits[k] for k, n in numbers.items())
