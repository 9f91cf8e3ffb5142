"""YAML config system with attribute access and dotlist overrides.

The port's own copy of ``latte_tpu/config/loader.py``: every entry point
takes a YAML path from ``configs/`` and optional ``key=value`` /
``key.sub=value`` overrides.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional

import yaml


class Config(dict):
    """dict with attribute access. Missing keys raise AttributeError so
    ``getattr(cfg, key, default)`` keeps working; keys that are present but
    null (YAML ``key:``) return None."""

    def __getattr__(self, name: str) -> Any:
        if name not in self:
            raise AttributeError(name)
        v = self[name]
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()
        }


def _parse_value(s: str) -> Any:
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def apply_overrides(cfg: Config, overrides: Iterable[str]) -> Config:
    """Apply ``a.b.c=value`` style overrides in place."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, value = item.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = Config()
                node[p] = nxt
            node = nxt
        node[parts[-1]] = _parse_value(value)
    return cfg


def _to_config(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return Config({k: _to_config(v) for k, v in obj.items()})
    return obj


def load_config(path: str, overrides: Optional[Iterable[str]] = None) -> Config:
    with open(path) as f:
        cfg = _to_config(yaml.safe_load(f) or {})
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict() if isinstance(cfg, Config) else dict(cfg), f)
