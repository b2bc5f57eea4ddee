"""ConfigNode — a nested attribute-access config container.

The port's copy of ``multimodal_tta_tpu/conf/node.py``, cut to what the
ported modules read: attribute and item access, dotted ``select`` with a
default and ``to_container``. Writing, merging, YAML loading and ``${...}``
interpolation stay with the config-composition slice.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

_MISSING = object()


class ConfigNode:
    """A dict-like config node with attribute access and dotted selection."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[str(k)] = _wrap(v)

    def __getattr__(self, key: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if key in data:
            return data[key]
        raise AttributeError(f"Config has no key '{key}'. Available: {sorted(data.keys())}")

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __bool__(self) -> bool:
        return bool(self._data)

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_container()!r})"

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def select(self, path: str, default: Any = _MISSING) -> Any:
        """Return the value at dotted ``path`` or ``default`` (None if unset).
        Numeric components index into lists."""
        node: Any = self
        for part in str(path).split("."):
            if isinstance(node, (ConfigNode, dict)) and part in node:
                node = node[part]
            elif isinstance(node, list) and part.lstrip("-").isdigit() and -len(node) <= int(part) < len(node):
                node = node[int(part)]
            else:
                return None if default is _MISSING else default
        return node

    def to_container(self) -> Dict[str, Any]:
        return {k: _unwrap(v) for k, v in self._data.items()}


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return value
    if isinstance(value, dict):
        return ConfigNode(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return value.to_container()
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value
