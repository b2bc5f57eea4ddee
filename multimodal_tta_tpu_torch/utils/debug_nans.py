"""``training.debug_nans``: stop at the first NaN (the counterpart of the
reference's ``jax_debug_nans``).

``install_nan_hooks(model)`` registers a forward hook on every module that
raises ``FloatingPointError`` naming the module when one of its outputs
holds a NaN (children report before their parents, so the first module to
produce one is named); ``checked_backward(loss)`` runs the backward under
``torch.autograd.detect_anomaly(check_nan=True)`` and raises
``FloatingPointError`` naming the autograd node that returned a NaN. As with
``jax_debug_nans`` (``jax_debug_infs`` is a flag of its own), an Inf passes.
Both only read values, so a run without a NaN computes bitwise what it
computes with the flag off; each check waits for the device.
"""

from __future__ import annotations

import warnings
from typing import List

import torch
from torch import nn


def _tensors(out):
    if torch.is_tensor(out):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


def check_nan(value: torch.Tensor, what: str) -> None:
    if value.is_floating_point() and bool(torch.isnan(value).any()):
        raise FloatingPointError(f"[debug_nans] NaN in {what}")


def install_nan_hooks(model: nn.Module, prefix: str = "model") -> List[torch.utils.hooks.RemovableHandle]:
    """A NaN check on the outputs of every module of ``model``; returns the
    hook handles."""
    handles = []
    for name, module in model.named_modules():
        what = f"the output of {prefix}{'.' + name if name else ''} ({type(module).__name__})"

        def hook(_module, _inputs, output, what=what):
            for t in _tensors(output):
                check_nan(t, what)

        handles.append(module.register_forward_hook(hook))
    return handles


def checked_backward(loss: torch.Tensor) -> None:
    """``loss.backward()`` under anomaly mode: a NaN from any backward node
    raises ``FloatingPointError`` naming the node."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Anomaly Detection has been enabled")
        warnings.filterwarnings("ignore", message="Error detected in")
        with torch.autograd.detect_anomaly(check_nan=True):
            try:
                loss.backward()
            except RuntimeError as e:
                if "nan" not in str(e).lower():
                    raise
                raise FloatingPointError(f"[debug_nans] {e}") from e


__all__ = ["install_nan_hooks", "checked_backward", "check_nan"]
