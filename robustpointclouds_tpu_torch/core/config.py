"""Hierarchical config files with `_base_` inheritance and dotted CLI overrides (counterpart of robustpointclouds_tpu/core/config.py).

The mmengine Config surface the reference relies on: `configs/*.py` files
with `_base_` chains, `_delete_` subtree replacement, and `--cfg-options`
dotted-key merges. A config is a plain Python file whose module-level names
become config keys; it is executed from its path, never imported as a
module of a package. Nested dicts get attribute access through ConfigDict.
"""
from __future__ import annotations

import copy
import importlib.util
import os
import sys
from typing import Any, Dict, List, Optional

_DELETE_KEY = "_delete_"
_BASE_KEY = "_base_"


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({copy.deepcopy(k, memo): copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict) and not isinstance(obj, ConfigDict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, ConfigDict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(ConfigDict.wrap(v) for v in obj)
        return obj


def _merge(base: dict, override: dict) -> dict:
    """Recursively merge `override` into `base` (override wins).

    A child dict containing `_delete_: True` replaces the base subtree instead
    of merging into it (mmengine `_delete_` semantics, see reference
    configs/second_hv_secfpn_8xb6-80e_kitti-3d-car.py usage).
    """
    out = dict(base)
    for key, val in override.items():
        if (
            isinstance(val, dict)
            and key in out
            and isinstance(out[key], dict)
            and not val.get(_DELETE_KEY, False)
        ):
            out[key] = _merge(out[key], val)
        else:
            if isinstance(val, dict):
                val = {k: v for k, v in val.items() if k != _DELETE_KEY}
            out[key] = copy.deepcopy(val)
    return out


def _exec_py_config(path: str) -> dict:
    path = os.path.abspath(path)
    spec = importlib.util.spec_from_file_location(
        f"_rpc_cfg_{abs(hash(path))}", path
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(spec.name, None)
    return {
        k: v
        for k, v in vars(mod).items()
        if not k.startswith("__") and not callable(v) and not isinstance(v, type(sys))
    }


def _set_dotted(cfg: dict, dotted_key: str, value: Any) -> None:
    keys = dotted_key.split(".")
    cur = cfg
    for k in keys[:-1]:
        if isinstance(cur, (list, tuple)):
            cur = cur[int(k)]
        else:
            if k not in cur or not isinstance(cur[k], (dict, list, tuple)):
                cur[k] = ConfigDict()
            cur = cur[k]
    last = keys[-1]
    if isinstance(cur, (list, tuple)):
        cur[int(last)] = value
    else:
        cur[last] = value


def _parse_value(text: str) -> Any:
    """Parse a CLI override value: literals, lists `a,b,c`, bools, numbers."""
    if "," in text:
        return [_parse_value(t) for t in text.split(",") if t != ""]
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


class Config:
    """Config loaded from a python file, with `_base_` inheritance.

    Usage::

        cfg = Config.fromfile("configs/kitti_3class_adversarial.py")
        cfg.merge_from_options({"model.adversary.sensor_error_bound": 0.3})
        cfg.model.bbox_head.num_classes
    """

    def __init__(self, data: Optional[dict] = None, filename: Optional[str] = None):
        self._data = ConfigDict.wrap(data or {})
        self._filename = filename

    # -- loading ------------------------------------------------------------
    @classmethod
    def fromfile(cls, path: str) -> "Config":
        data = cls._load_with_bases(path)
        return cls(data, filename=path)

    @staticmethod
    def _load_with_bases(path: str) -> dict:
        raw = _exec_py_config(path)
        bases = raw.pop(_BASE_KEY, [])
        if isinstance(bases, str):
            bases = [bases]
        merged: dict = {}
        cfg_dir = os.path.dirname(os.path.abspath(path))
        for base in bases:
            base_path = base if os.path.isabs(base) else os.path.join(cfg_dir, base)
            merged = _merge(merged, Config._load_with_bases(base_path))
        return _merge(merged, raw)

    # -- access -------------------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._data[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def to_dict(self) -> dict:
        return copy.deepcopy(dict(self._data))

    # -- mutation -----------------------------------------------------------
    def merge_from_options(self, options: Dict[str, Any]) -> None:
        """Apply dotted-key overrides, e.g. {"train.max_epochs": 30}."""
        for key, value in options.items():
            _set_dotted(self._data, key, ConfigDict.wrap(value))

    def merge_from_cli(self, pairs: List[str]) -> None:
        """Apply 'key=value' strings from --cfg-options."""
        opts: Dict[str, Any] = {}
        for pair in pairs:
            if "=" not in pair:
                raise ValueError(f"cfg-option must be key=value, got {pair!r}")
            key, _, value = pair.partition("=")
            opts[key] = _parse_value(value)
        self.merge_from_options(opts)

    def __repr__(self) -> str:
        return f"Config(filename={self._filename!r}, keys={sorted(self._data.keys())})"
