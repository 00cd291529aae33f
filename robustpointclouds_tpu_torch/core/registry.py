"""String-keyed registries for models, adversaries and hooks (counterpart of robustpointclouds_tpu/core/registry.py).

The reference's `ADVERSARIES` registry with `build_adversary(cfg)` and the
mmdet3d `MODELS` registration pattern, without the mmengine dependency. The
port's classes register under the JAX package's names: the adversaries
`VoxelPerturber` and `StrongVoxelPerturber`, the models `VoxelNet`,
`CenterPoint`, `PointPillars` and `StrongAdversarialVoxelNet`. The modules
that define them register on import; `build_model` / `build_adversary`
import them first, so a name resolves whatever the caller imported.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._items: Dict[str, Callable] = {}

    def register_module(self, module: Optional[Callable] = None, name: Optional[str] = None):
        def _register(cls):
            key = name or cls.__name__
            if key in self._items and self._items[key] is not cls:
                raise KeyError(f"{key!r} already registered in {self.name!r}")
            self._items[key] = cls
            return cls

        if module is not None:
            return _register(module)
        return _register

    def get(self, key: str) -> Callable:
        if key not in self._items:
            raise KeyError(
                f"{key!r} not found in registry {self.name!r}; "
                f"available: {sorted(self._items)}"
            )
        return self._items[key]

    def build(self, cfg: Optional[dict], **extra: Any):
        """Build from a {'type': Name, ...kwargs} dict (mmengine-style)."""
        if cfg is None:
            return None
        cfg = dict(cfg)
        type_name = cfg.pop("type")
        cls = self.get(type_name)
        cfg.update(extra)
        return cls(**cfg)

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def keys(self):
        return self._items.keys()


MODELS = Registry("models")
ADVERSARIES = Registry("adversaries")
HOOKS = Registry("hooks")

# the modules whose classes register themselves
_REGISTERING = ("..nn.perturber", "..models.voxelnet", "..models.centerpoint",
                "..models.pointpillars", "..models.strong")


def _import_registering() -> None:
    for mod in _REGISTERING:
        importlib.import_module(mod, __package__)


def build_adversary(cfg: Optional[dict]):
    """Build an adversary module from config (reference models/builder.py:9-11)."""
    _import_registering()
    return ADVERSARIES.build(cfg)


def build_model(cfg: Optional[dict]):
    _import_registering()
    return MODELS.build(cfg)
