"""Component registry (the port's copy of ``multimodal_tta_tpu/registry.py``).

Name -> class registries with decorator-based registration, separate from
the JAX package's so both can be imported in one process (the parity tests
do). The public API mirrors the reference framework (reference:
src/registry.py:10-167):

    from multimodal_tta_tpu_torch.registry import register_model, get_model

    @register_model("unet")
    class UNet3D(...): ...

    cls = get_model("unet")

Seven global registries are exposed (MODELS, DATASETS, DATASET_BUILDERS,
EVALUATION_STRATEGIES, CRITERIA, PROVIDERS, PLUGINS). The reference never
populates CRITERIA/PROVIDERS/PLUGINS (vestigial hooks of a parent project);
we keep them for API parity and use CRITERIA for registered loss builders.
TTA_METHODS is new in this framework.

The per-kind module-level helpers (``register_model`` / ``get_model`` /
``list_models`` and friends) are synthesized from the ``_KINDS`` table below
rather than written out one by one — one row per registry kind keeps the
surface in a single place while exposing exactly the reference's names.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Type


class Registry:
    """A simple name -> class mapping with decorator registration.

    ``auto_import`` names the package whose import populates this registry
    (registration is an import side effect); a failed ``get`` imports it
    once and retries, so callers that reach a registry through
    ``get_<kind>()`` alone don't silently depend on some OTHER module
    having imported the registering package first.
    """

    def __init__(self, name: str, auto_import: Optional[str] = None):
        self.name = name
        self._registry: Dict[str, Type] = {}
        self._auto_import = auto_import

    def _bind(self, name: str, cls: Type) -> Type:
        prior = self._registry.get(name)
        if prior is not None and prior is not cls:
            warnings.warn(f"'{name}' is already registered in {self.name}; overwriting")
        self._registry[name] = cls
        return cls

    def register(self, name: str, cls: Optional[Type] = None) -> Callable:
        """Register a component.

        Usable as a decorator ``@registry.register("x")`` or called directly
        ``registry.register("x", Cls)``.
        """
        if cls is not None:
            return self._bind(name, cls)
        return lambda c: self._bind(name, c)

    def get(self, name: str) -> Type:
        try:
            return self._registry[name]
        except KeyError:
            if self._auto_import is not None:
                mod, self._auto_import = self._auto_import, None
                import importlib

                importlib.import_module(mod)
                return self.get(name)
            raise KeyError(
                f"'{name}' is not registered in {self.name}. "
                f"Available: {sorted(self._registry.keys())}"
            ) from None

    def has(self, name: str) -> bool:
        return name in self._registry

    def list_all(self) -> List[str]:
        return list(self._registry.keys())

    def clear(self) -> None:
        self._registry.clear()

    def __contains__(self, name: str) -> bool:
        return name in self._registry

    def __len__(self) -> int:
        return len(self._registry)


# One row per registry kind: singular helper suffix -> (plural, Registry).
# The plural doubles as the ``list_<plural>`` helper suffix and the key in
# ``list_all_components()``; the globals MODELS/DATASETS/... are bound below.
_KINDS: Dict[str, str] = {
    "model": "models",
    "dataset": "datasets",
    "dataset_builder": "dataset_builders",
    "evaluation_strategy": "evaluation_strategies",
    "criterion": "criteria",
    "provider": "providers",
    "plugin": "plugins",
    "tta_method": "tta_methods",
}

# Package whose import populates each registry (see Registry.get's lazy
# retry). CRITERIA/PROVIDERS/PLUGINS have no registering package — they are
# vestigial in the reference too.
_AUTO_IMPORT: Dict[str, str] = {
    "models": "multimodal_tta_tpu_torch.models",
    "datasets": "multimodal_tta_tpu_torch.data",
    "dataset_builders": "multimodal_tta_tpu_torch.data",
    "evaluation_strategies": "multimodal_tta_tpu_torch.evaluation",
    "tta_methods": "multimodal_tta_tpu_torch.tta",
}

_REGISTRIES: Dict[str, Registry] = {
    plural: Registry(plural, auto_import=_AUTO_IMPORT.get(plural))
    for plural in _KINDS.values()
}

# Global registry objects under the reference's ALL_CAPS names.
globals().update({plural.upper(): reg for plural, reg in _REGISTRIES.items()})

# Keep static analyzers / IDEs aware of the canonical eight.
MODELS: Registry = _REGISTRIES["models"]
DATASETS: Registry = _REGISTRIES["datasets"]
DATASET_BUILDERS: Registry = _REGISTRIES["dataset_builders"]
EVALUATION_STRATEGIES: Registry = _REGISTRIES["evaluation_strategies"]
CRITERIA: Registry = _REGISTRIES["criteria"]
PROVIDERS: Registry = _REGISTRIES["providers"]
PLUGINS: Registry = _REGISTRIES["plugins"]
TTA_METHODS: Registry = _REGISTRIES["tta_methods"]


def _synthesize_helpers() -> List[str]:
    """Create register_<kind> / get_<kind> / list_<plural> module functions."""
    made: List[str] = []
    for singular, plural in _KINDS.items():
        reg = _REGISTRIES[plural]

        def _register(name: str, _reg: Registry = reg) -> Callable:
            return _reg.register(name)

        def _get(name: str, _reg: Registry = reg) -> Type:
            return _reg.get(name)

        def _list(_reg: Registry = reg) -> List[str]:
            return _reg.list_all()

        for fn, py_name in (
            (_register, f"register_{singular}"),
            (_get, f"get_{singular}"),
            (_list, f"list_{plural}"),
        ):
            fn.__name__ = fn.__qualname__ = py_name
            fn.__doc__ = f"{py_name.split('_')[0].capitalize()} helper for the '{plural}' registry."
            globals()[py_name] = fn
            made.append(py_name)
    return made


_HELPER_NAMES = _synthesize_helpers()


def list_all_components() -> Dict[str, List[str]]:
    return {plural: reg.list_all() for plural, reg in _REGISTRIES.items()}


__all__ = (
    ["Registry", "list_all_components"]
    + [plural.upper() for plural in _KINDS.values()]
    + _HELPER_NAMES
)
