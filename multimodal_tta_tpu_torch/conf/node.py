"""ConfigNode — a nested attribute-access config container (the port's copy
of ``multimodal_tta_tpu/conf/node.py``).

YAML is read and written by ``conf/yaml_subset.py``, which gives what
``yaml.safe_load`` gives on the configs, so the port needs no PyYAML. The
access patterns the framework relies on:

  - attribute and item access: ``cfg.training.epochs`` / ``cfg["training"]``
  - dotted-path select with default: ``cfg.select("training.criterion.sigmoid", True)``
  - deep merge (later wins) for config composition
  - ``${a.b}`` interpolation resolution

It is intentionally small: no structured schemas, no lazy resolvers beyond
string interpolation, no read-only flags.
"""

from __future__ import annotations

import copy
import datetime
import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple, Union

from . import yaml_subset

_MISSING = object()
_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class ConfigNode:
    """A dict-like config node with attribute access and dotted selection."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        # NOTE: store in __dict__ directly to avoid recursion in __setattr__.
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[str(k)] = _wrap(v)

    # ---------- basic mapping protocol ----------
    def __getattr__(self, key: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if key in data:
            return data[key]
        raise AttributeError(f"Config has no key '{key}'. Available: {sorted(data.keys())}")

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __bool__(self) -> bool:
        return bool(self._data)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, ConfigNode):
            return self.to_container() == other.to_container()
        if isinstance(other, dict):
            return self.to_container() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_container()!r})"

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def pop(self, key: str, *args) -> Any:
        return self._data.pop(key, *args)

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            self._data[key] = _wrap(default)
        return self._data[key]

    # ---------- dotted-path helpers ----------
    def select(self, path: str, default: Any = _MISSING) -> Any:
        """Return the value at dotted ``path`` or ``default`` (None if unset).
        Numeric components index into lists (Hydra list-override grammar)."""
        node: Any = self
        for part in str(path).split("."):
            if isinstance(node, (ConfigNode, dict)) and part in node:
                node = node[part]
            elif isinstance(node, list) and part.lstrip("-").isdigit() and -len(node) <= int(part) < len(node):
                node = node[int(part)]
            else:
                return None if default is _MISSING else default
        return node

    def set_path(self, path: str, value: Any) -> None:
        """Set value at dotted ``path``, creating intermediate nodes. Numeric
        components index existing lists (out-of-range indices error)."""
        parts = str(path).split(".")
        node: Any = self
        for i, part in enumerate(parts[:-1]):
            if isinstance(node, list):
                if not part.lstrip("-").isdigit():
                    raise KeyError(f"Cannot key list with '{part}' in path '{path}'")
                node = node[int(part)]
                continue
            nxt = node.get(part)
            if not isinstance(nxt, (ConfigNode, list)):
                nxt = ConfigNode()
                node[part] = nxt
            node = nxt
        last = parts[-1]
        if isinstance(node, list):
            node[int(last)] = _wrap(value)
        else:
            node[last] = value

    def has_path(self, path: str) -> bool:
        sentinel = object()
        return self.select(path, sentinel) is not sentinel

    # ---------- merge / copy ----------
    def merge(self, other: Union["ConfigNode", Dict[str, Any]]) -> "ConfigNode":
        """Deep-merge ``other`` into self (other wins). Returns self."""
        items = other.items() if isinstance(other, (ConfigNode, dict)) else []
        for k, v in items:
            k = str(k)
            cur = self._data.get(k)
            if isinstance(cur, ConfigNode) and isinstance(v, (ConfigNode, dict)):
                cur.merge(v)
            else:
                self._data[k] = _wrap(copy.deepcopy(_unwrap(v)))
        return self

    def copy(self) -> "ConfigNode":
        return ConfigNode(self.to_container())

    # ---------- conversion ----------
    def to_container(self) -> Dict[str, Any]:
        return {k: _unwrap(v) for k, v in self._data.items()}

    def to_yaml(self) -> str:
        return yaml_subset.dump(self.to_container())

    # ---------- interpolation ----------
    def resolve(self, _root: Optional["ConfigNode"] = None) -> "ConfigNode":
        """Resolve ``${dotted.path}`` and ``${now:FMT}`` interpolations in place."""
        root = _root or self
        for k, v in list(self._data.items()):
            self._data[k] = _resolve_value(v, root)
        return self


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


def _resolve_value(value: Any, root: ConfigNode, _depth: int = 0) -> Any:
    if _depth > 20:
        raise ValueError("Config interpolation too deep (cycle?)")
    if isinstance(value, ConfigNode):
        for k, v in list(value._data.items()):
            value._data[k] = _resolve_value(v, root, _depth)
        return value
    if isinstance(value, list):
        return [_resolve_value(v, root, _depth) for v in value]
    if isinstance(value, str):
        return _resolve_str(value, root, _depth)
    return value


def _resolve_str(s: str, root: ConfigNode, depth: int) -> Any:
    m = _INTERP_RE.fullmatch(s)
    if m:
        # Whole-string interpolation may return a non-string value.
        out = _lookup_interp(m.group(1), root)
        return _resolve_value(out, root, depth + 1)

    def sub(match: "re.Match[str]") -> str:
        out = _lookup_interp(match.group(1), root)
        out = _resolve_value(out, root, depth + 1)
        return str(out)

    return _INTERP_RE.sub(sub, s)


def _lookup_interp(expr: str, root: ConfigNode) -> Any:
    expr = expr.strip()
    if expr.startswith("now:"):
        fmt = expr[len("now:"):]
        return datetime.datetime.now().strftime(fmt)
    if expr == "now":
        return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    if expr.startswith("env:"):
        name = expr[len("env:"):]
        return os.environ.get(name, "")
    val = root.select(expr, _MISSING)
    if val is _MISSING:
        raise KeyError(f"Interpolation '${{{expr}}}' not found in config")
    return val


def from_yaml_str(text: str) -> ConfigNode:
    data = yaml_subset.load(text)
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ValueError(f"Top-level YAML must be a mapping, got {type(data).__name__}")
    return ConfigNode(data)


def load_yaml_file(path: str) -> Tuple[ConfigNode, Optional[str]]:
    """Load a YAML file; returns (node, package_directive).

    Recognizes the Hydra ``# @package <pkg>`` header comment on the first
    lines of the file (used by the reference's configs/_global_patches/*).
    """
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    package: Optional[str] = None
    for line in text.splitlines()[:5]:
        line = line.strip()
        m = re.match(r"#\s*@package\s+([\w./_]+)", line)
        if m:
            package = m.group(1)
            break
    return from_yaml_str(text), package
