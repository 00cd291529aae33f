"""Checkpoints of a Trainer on torch.save (counterpart of robustpointclouds_tpu/train/checkpoint.py).

A checkpoint holds what the JAX TrainState holds: the model's state_dict
(parameters and BatchNorm running statistics) and the port's TrainState
(step, the shared update count, both chains' Adam moments and the NaN
ladder's tensors; a StrongTrainState's momentum carry and dynamic scale
too). Each epoch's checkpoint is one file,
`<directory>/epoch_<N>.pt`, written to a temporary name and renamed, so a
crash never leaves a torn file; the newest `max_to_keep` are kept. Files are
read back with `torch.load(weights_only=True)`, which unpickles tensors and
plain containers only. In a data-parallel run (`group`) only the group's
rank 0 writes, as JAX's `single_process_io`: the state is replicated, so
rank 0 holds all of it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

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
    def __init__(self, directory: str, max_to_keep: int = 10, save_interval_epochs: int = 5,
                 group=None):
        """`group`: a torch.distributed process group whose rank 0 alone
        writes (save, maybe_save and save_best do nothing on the others)."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_epochs = save_interval_epochs
        self.writes = group is None or dist.get_rank(group) == 0

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def epochs(self) -> List[int]:
        """The saved epochs, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        found = (_EPOCH_FILE.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, epoch: int, trainer: Trainer) -> None:
        if not self.writes:
            return
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
        if self.writes and (epoch + 1) % self.save_interval_epochs == 0:
            self.save(epoch, trainer)
            return True
        return False

    # -- best-metric checkpoint (reference CheckpointHook save_best) ------------
    def save_best(self, metric_value: float, trainer: Trainer, epoch: int) -> bool:
        """Keep the single best-metric checkpoint as <dir>/best.pt. Returns
        True when this value beat the stored best (higher is better)."""
        if not self.writes:
            return False
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


# the detector trunk a zoo warm start must load whole, per layout (the JAX
# package's strict prefixes in the port's module names; head tensors may skip:
# the plain and DCN CenterHead differ, and the adversary has no zoo tensors)
_STRICT = {"centerpoint": ("pts_middle_encoder", "pts_backbone", "pts_neck"),
           "pointpillars": ("voxel_encoder.pfn_layers", "backbone", "neck"),
           "second": ("middle_encoder", "backbone", "neck")}


def load_pretrained(trainer: Trainer, path: str) -> None:
    """Warm start: load model weights (parameters and BatchNorm running
    statistics); the optimizer state and counters stay as they are. `path`:

      * an mmdet3d zoo `.pth` (SECOND, PointPillars or voxel CenterPoint),
        converted by key through tools/convert_torch_checkpoint as the JAX
        package converts it. Dropping a tensor of the detector trunk, or
        loading no parameter at all, raises. Tensors the file lacks (the
        adversary, the backbone convs past each stage's first) keep their
        values. The file is unpickled with weights_only=False, as JAX reads
        it: load only files you trust;
      * a port checkpoint, a file or a checkpoint directory (its latest
        epoch), whose whole model state_dict is loaded."""
    if path.endswith(".pth"):
        from ..tools.convert_torch_checkpoint import (
            convert_centerpoint_state_dict, convert_pointpillars_state_dict,
            convert_second_state_dict, detect_state_dict_layout, load_torch_checkpoint,
            merge_into_state_dict)

        sd = load_torch_checkpoint(path)
        layout = detect_state_dict_layout(sd)
        if layout == "centerpoint":
            converted = convert_centerpoint_state_dict(
                sd, dcn_head=bool(getattr(trainer.model_cfg, "use_dcn_head", False)))
        elif layout == "pointpillars":
            converted = convert_pointpillars_state_dict(sd)
        else:
            converted = convert_second_state_dict(sd)
        loaded, skipped = merge_into_state_dict(
            trainer.model, converted, strict_prefixes=_STRICT[layout],
            zero_error=(f"warm start from {path} (detected layout: {layout}) loaded ZERO "
                        "parameter tensors — the checkpoint family does not match this "
                        "model's architecture"))
        print(f"[load-from] {path} ({layout}): loaded {len(loaded)} tensors, "
              f"skipped {len(skipped)}", flush=True)
        return
    if os.path.isdir(path):
        mgr = CheckpointManager(path)
        epoch = mgr.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint found in {path}")
        path = mgr._path(epoch)
    trainer.model.load_state_dict(_read(path, trainer.device)["model"])
    print(f"[load-from] loaded the model weights of {path}", flush=True)
