"""Checkpoints of a Trainer on torch.save (counterpart of robustpointclouds_tpu/train/checkpoint.py).

A checkpoint holds what the JAX TrainState holds: the model's state_dict
(parameters and BatchNorm running statistics) and the port's TrainState
(step, the shared update count, both chains' Adam moments and the NaN
ladder's tensors; a StrongTrainState's momentum carry and dynamic scale
too). Each epoch's checkpoint is one file,
`<directory>/epoch_<N>.pt`, written to a temporary name and renamed, so a
crash never leaves a torn file; the newest `max_to_keep` are kept. Files are
read back with `torch.load(weights_only=True)`, which unpickles tensors and
plain containers only.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional

import torch

from .loop import TrainState, Trainer

_EPOCH_FILE = re.compile(r"^epoch_(\d+)\.pt$")


def _payload(trainer: Trainer) -> Dict:
    if trainer.state is None:
        raise RuntimeError("the trainer has no state to save: call init_state() first")
    st = trainer.state
    return {"model": trainer.model.state_dict(),
            "train_state": {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}}


def _write(path: str, payload: Dict) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _read(path: str, device: torch.device) -> Dict:
    return torch.load(path, map_location=device, weights_only=True)


def _load_into(trainer: Trainer, payload: Dict) -> TrainState:
    trainer.model.load_state_dict(payload["model"])
    trainer.state = trainer.state_cls(**payload["train_state"])
    return trainer.state


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 10, save_interval_epochs: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_epochs = save_interval_epochs

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def epochs(self) -> List[int]:
        """The saved epochs, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        found = (_EPOCH_FILE.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, epoch: int, trainer: Trainer) -> None:
        os.makedirs(self.directory, exist_ok=True)
        _write(self._path(epoch), _payload(trainer))
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, trainer: Trainer, epoch: Optional[int] = None) -> TrainState:
        """Load the checkpoint of `epoch` (the latest by default) into the
        trainer's model and state; a model of another shape raises."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return _load_into(trainer, _read(self._path(epoch), trainer.device))

    def maybe_save(self, epoch: int, trainer: Trainer) -> bool:
        if (epoch + 1) % self.save_interval_epochs == 0:
            self.save(epoch, trainer)
            return True
        return False

    # -- best-metric checkpoint (reference CheckpointHook save_best) ------------
    def save_best(self, metric_value: float, trainer: Trainer, epoch: int) -> bool:
        """Keep the single best-metric checkpoint as <dir>/best.pt. Returns
        True when this value beat the stored best (higher is better)."""
        best_file = os.path.join(self.directory, "best_metric.json")
        if os.path.isfile(best_file):
            with open(best_file) as f:
                prev = json.load(f)
            if metric_value <= prev.get("value", -float("inf")):
                return False
        os.makedirs(self.directory, exist_ok=True)
        _write(os.path.join(self.directory, "best.pt"), _payload(trainer))
        with open(best_file, "w") as f:
            json.dump({"value": float(metric_value), "epoch": int(epoch)}, f)
        return True

    def restore_best(self, trainer: Trainer) -> TrainState:
        path = os.path.join(self.directory, "best.pt")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no best checkpoint under {self.directory}")
        return _load_into(trainer, _read(path, trainer.device))


def load_pretrained(trainer: Trainer, path: str) -> None:
    """Warm start: load the model weights (parameters and BatchNorm running
    statistics) of a port checkpoint, a file or a checkpoint directory (its
    latest epoch); the optimizer state and counters stay as they are.

    A zoo `.pth` (mmdet3d) is not ported yet (ROADMAP.md, M11): the JAX
    encoder's z-fold is dz-major where mmdet3d's is channel-major, and flax
    'SAME' pads stride-2 convs otherwise, so its tensors need remapping."""
    if path.endswith(".pth"):
        raise NotImplementedError(
            f"{path}: warm starts from zoo .pth checkpoints are not ported yet")
    if os.path.isdir(path):
        mgr = CheckpointManager(path)
        epoch = mgr.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint found in {path}")
        path = mgr._path(epoch)
    trainer.model.load_state_dict(_read(path, trainer.device)["model"])
    print(f"[load-from] loaded the model weights of {path}", flush=True)
