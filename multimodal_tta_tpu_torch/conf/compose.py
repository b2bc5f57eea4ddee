"""Hydra-style config composition (the port's copy of
``multimodal_tta_tpu/conf/compose.py``, reading YAML with
``conf/yaml_subset.py`` instead of PyYAML).

The subset of Hydra semantics the config tree uses:

  - defaults list processing with config groups (``- dataset: hecktor21``)
  - ``_self_`` placement
  - nested defaults inside group files (``- /_global_patches: hecktor21``)
  - ``# @package _global_`` header directive
  - CLI overrides: group selection (``task=hecktor21``), dotted value
    overrides (``training.epochs=3``), additions (``+foo.bar=1``) and
    deletions (``~foo``)
  - ``${a.b}`` / ``${now:%Y%m%d}`` interpolation
  - run-dir templating + optional chdir, mirroring hydra.run.dir behaviour

The port's CLIs (``multimodal_tta_tpu_torch/cli/``) take the same override
grammar as ``main.py``, ``adapt.py`` and ``predict.py``.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Any, Dict, List, Optional, Sequence

from . import yaml_subset
from .node import ConfigNode, load_yaml_file


_SCI_FLOAT_RE = re.compile(r"^[+-]?\d+(\.\d*)?[eE][+-]?\d+$")


def _parse_cli_value(raw: str) -> Any:
    """Parse an override value with YAML semantics ('5'->int, '[1,2]'->list).

    YAML 1.1 does not recognize dot-less scientific notation ('5e-3'), which
    the reference launch scripts use (reference: train_hecktor21.sh:21), so
    fall back to float() for that pattern.
    """
    try:
        val = yaml_subset.load(raw)
    except yaml_subset.YAMLSubsetError:
        return raw
    if isinstance(val, str) and _SCI_FLOAT_RE.match(val.strip()):
        return float(val)
    return val


class _Override:
    __slots__ = ("key", "value", "kind")

    def __init__(self, key: str, value: Any, kind: str):
        self.key = key
        self.value = value
        self.kind = kind  # "set" | "add" | "del"


def parse_overrides(tokens: Sequence[str]) -> List[_Override]:
    out: List[_Override] = []
    for tok in tokens:
        tok = str(tok)
        if tok.startswith("~"):
            out.append(_Override(tok[1:], None, "del"))
            continue
        kind = "set"
        if tok.startswith("++"):
            tok, kind = tok[2:], "set"
        elif tok.startswith("+"):
            tok, kind = tok[1:], "add"
        if "=" not in tok:
            raise ValueError(f"Invalid override (expected key=value): '{tok}'")
        key, raw = tok.split("=", 1)
        out.append(_Override(key.strip(), _parse_cli_value(raw), kind))
    return out


class Composer:
    def __init__(self, config_dir: str):
        self.config_dir = os.path.abspath(config_dir)

    # ------------------------------------------------------------------
    def compose(self, config_name: str, overrides: Sequence[str] = ()) -> ConfigNode:
        ovs = parse_overrides(overrides)

        # Group selections from CLI (e.g. "task=hecktor21") replace the
        # corresponding defaults-list entry before composition.
        group_over: Dict[str, Any] = {}
        value_over: List[_Override] = []
        for ov in ovs:
            if ov.kind == "set" and self._is_group(ov.key):
                group_over[ov.key] = ov.value
            else:
                value_over.append(ov)

        root = ConfigNode()
        self._compose_file(root, config_name, package="_global_", group_over=group_over)

        for ov in value_over:
            if ov.kind == "del":
                self._delete_path(root, ov.key)
            else:
                root.set_path(ov.key, ov.value)

        root.resolve()
        return root

    # ------------------------------------------------------------------
    def _is_group(self, key: str) -> bool:
        if "." in key:
            return False
        return os.path.isdir(os.path.join(self.config_dir, key))

    def _find_config_file(self, rel: str) -> Optional[str]:
        for ext in (".yaml", ".yml"):
            p = os.path.join(self.config_dir, rel + ext)
            if os.path.exists(p):
                return p
        return None

    @staticmethod
    def _delete_path(root: ConfigNode, path: str) -> None:
        parts = path.split(".")
        node: Any = root
        for p in parts[:-1]:
            node = node.get(p) if isinstance(node, ConfigNode) else None
            if node is None:
                return
        if isinstance(node, ConfigNode) and parts[-1] in node:
            del node[parts[-1]]

    def _compose_file(
        self,
        root: ConfigNode,
        rel_name: str,
        package: str,
        group_over: Dict[str, Any],
        _seen: Optional[set] = None,
    ) -> None:
        """Merge config file ``rel_name`` (path relative to config_dir, no
        extension) into ``root`` under ``package`` after processing its
        defaults list."""
        _seen = _seen if _seen is not None else set()
        path = self._find_config_file(rel_name)
        if path is None:
            raise FileNotFoundError(
                f"Config '{rel_name}' not found under {self.config_dir} "
                f"(looked for {rel_name}.yaml/.yml)"
            )
        if path in _seen:
            raise ValueError(f"Config include cycle at {path}")
        _seen = _seen | {path}

        node, pkg_directive = load_yaml_file(path)
        if pkg_directive is not None:
            package = pkg_directive

        defaults = node.pop("defaults", None)
        own_dir = os.path.dirname(rel_name)  # group dir of this file

        self_done = False
        if defaults is not None:
            for entry in list(defaults):
                if entry == "_self_":
                    self._merge_at(root, node, package)
                    self_done = True
                    continue
                if isinstance(entry, str):
                    # bare include from the same group dir, e.g. "- _base"
                    inc = os.path.join(own_dir, entry) if own_dir else entry
                    self._compose_file(root, inc, package=package, group_over=group_over, _seen=_seen)
                    continue
                if isinstance(entry, (dict, ConfigNode)):
                    items = list(entry.items())
                    if len(items) != 1:
                        raise ValueError(f"Bad defaults entry in {path}: {entry}")
                    gkey, gval = items[0]
                    gkey = str(gkey)
                    optional = False
                    if gkey.startswith("optional "):
                        optional = True
                        gkey = gkey[len("optional "):]
                    # group override from CLI (group key without leading /)
                    cli_key = gkey.lstrip("/")
                    if cli_key in group_over:
                        gval = group_over[cli_key]
                    if gval is None:
                        continue
                    if gkey.startswith("/"):
                        gdir = gkey[1:]
                    else:
                        gdir = os.path.join(own_dir, gkey) if own_dir else gkey
                    # Default package: the group path (Hydra semantics).
                    child_pkg = gdir.replace("/", ".").lstrip("_") if gdir else package
                    # Files under dirs beginning with '_' (e.g. _global_patches)
                    # declare their package via the @package directive; give
                    # them _global_ as fallback.
                    if os.path.basename(gdir).startswith("_"):
                        child_pkg = "_global_"
                    inc = os.path.join(gdir, str(gval))
                    try:
                        self._compose_file(root, inc, package=child_pkg, group_over=group_over, _seen=_seen)
                    except FileNotFoundError:
                        if not optional:
                            raise
                    continue
                raise ValueError(f"Unsupported defaults entry in {path}: {entry!r}")

        if not self_done:
            self._merge_at(root, node, package)

    @staticmethod
    def _merge_at(root: ConfigNode, node: ConfigNode, package: str) -> None:
        if package in ("_global_", "", None):
            root.merge(node)
            return
        target = ConfigNode()
        target.set_path(package, node)
        root.merge(target)


def compose(config_dir: str, config_name: str = "config", overrides: Sequence[str] = ()) -> ConfigNode:
    return Composer(config_dir).compose(config_name, overrides)


def setup_run_dir(cfg: ConfigNode, chdir: bool = True) -> str:
    """Create the templated run directory and optionally chdir into it.

    Mirrors the reference's hydra.run.dir + hydra.job.chdir behaviour
    (reference: configs/config.yaml:10-14). The composed config is saved to
    ``<run_dir>/.hydra_equiv/config.yaml`` for provenance.
    """
    run_dir = cfg.select("hydra.run.dir", None)
    if run_dir is None:
        save_dir = cfg.select("task.save_dir", "./outputs")
        run_name = cfg.select("task.run_name", cfg.select("training.run_name", "run"))
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        run_dir = os.path.join(str(save_dir), str(run_name), stamp)
    run_dir = os.path.abspath(str(run_dir))
    os.makedirs(run_dir, exist_ok=True)

    prov_dir = os.path.join(run_dir, ".hydra_equiv")
    os.makedirs(prov_dir, exist_ok=True)
    with open(os.path.join(prov_dir, "config.yaml"), "w", encoding="utf-8") as f:
        f.write(cfg.to_yaml())

    if chdir and bool(cfg.select("hydra.job.chdir", True)):
        os.chdir(run_dir)
    return run_dir
