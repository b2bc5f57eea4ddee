"""Component registry (the port's copy of ``multimodal_tta_tpu/registry.py``).

Name -> class registries with decorator registration, separate from the JAX
package's so both can be imported in one process (the parity tests do):

    from multimodal_tta_tpu_torch.registry import register_model, get_model

    @register_model("unet")
    class UNet3D(nn.Module): ...

It holds the kinds the port has so far — models, TTA methods, evaluation
strategies and dataset builders (none registered yet: the builders come with
the data-plumbing slice); the reference's other kinds join with the slices
that register into them.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Type


class Registry:
    """A name -> class mapping with decorator registration. ``auto_import``
    names the package whose import populates it; a failed ``get`` imports
    it once and retries."""

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

    def list_all(self) -> List[str]:
        return list(self._registry.keys())


MODELS = Registry("models", auto_import="multimodal_tta_tpu_torch.models")
TTA_METHODS = Registry("tta_methods", auto_import="multimodal_tta_tpu_torch.tta")
EVALUATION_STRATEGIES = Registry(
    "evaluation_strategies", auto_import="multimodal_tta_tpu_torch.evaluation"
)
DATASET_BUILDERS = Registry("dataset_builders", auto_import="multimodal_tta_tpu_torch.data")


def register_model(name: str) -> Callable:
    return MODELS.register(name)


def get_model(name: str) -> Type:
    return MODELS.get(name)


def register_tta_method(name: str) -> Callable:
    return TTA_METHODS.register(name)


def get_tta_method(name: str) -> Type:
    return TTA_METHODS.get(name)


def register_evaluation_strategy(name: str) -> Callable:
    return EVALUATION_STRATEGIES.register(name)


def get_evaluation_strategy(name: str) -> Type:
    return EVALUATION_STRATEGIES.get(name)


def register_dataset_builder(name: str) -> Callable:
    return DATASET_BUILDERS.register(name)


def get_dataset_builder(name: str) -> Type:
    return DATASET_BUILDERS.get(name)
