"""Typed config accessors over ConfigNode dotted paths (the port's copy of
``multimodal_tta_tpu/utils/config.py``)."""

from __future__ import annotations

from typing import Any, Optional, Type

from ..conf.node import ConfigNode

_MISSING = object()


def _select(cfg: Any, path: str, default: Any = _MISSING) -> Any:
    if isinstance(cfg, ConfigNode):
        return cfg.select(path, default)
    node = cfg
    for part in str(path).split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return default
    return node


def get_config(cfg: Any, path: str, default: Any = None, type_: Optional[Type] = None) -> Any:
    value = _select(cfg, path, _MISSING)
    if value is _MISSING or value is None:
        return default
    if type_ is not None and type_ is not Any:
        if type_ is float and isinstance(value, int):
            return float(value)
        if type_ is int and isinstance(value, float) and float(value).is_integer():
            return int(value)
        if type_ is bool and isinstance(value, (int, str)):
            if isinstance(value, str):
                return value.strip().lower() in ("1", "true", "yes", "on")
            return bool(value)
        if not isinstance(value, type_):
            return default
    return value
