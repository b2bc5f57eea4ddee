"""Train state (the port of ``multimodal_tta_tpu/core/train_state.py``).

Where the reference threads one functional pytree through a jitted step, the
port holds the live objects: the model (whose parameters the optimizer
updates in place), the optimizer, the step count and, with
``training.ema``, the EMA shadow of the parameters as a dict of tensors.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from .optim import MultiSteps, Optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    # Polyak/EMA shadow of the params by name (training.ema) — None when
    # disabled. SegTrainer updates it after every applied step; evaluation
    # reads it through trainer.eval_state() when training.ema.eval is on.
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    def apply_gradients(self) -> bool:
        """Step the optimizer on the params' ``.grad`` and count the step;
        returns whether the params moved (under ``MultiSteps`` only every
        k-th step does)."""
        if isinstance(self.optimizer, MultiSteps):
            applied = self.optimizer.step()
        else:
            self.optimizer.step()
            applied = True
        self.step += 1
        return applied


def param_count(model: nn.Module) -> int:
    return sum(int(p.numel()) for p in model.parameters())


@torch.no_grad()
def shadow_module(model: nn.Module, params: Mapping[str, torch.Tensor],
                  into: Optional[nn.Module] = None) -> nn.Module:
    """A module like ``model`` carrying ``params`` (by name) and ``model``'s
    live buffers (a BatchNorm's running statistics; the reference swaps only
    ``params`` and evaluates with the live ``batch_stats``): ``into`` when
    given, else a frozen copy of ``model`` made once. ``model`` itself, and
    an optimizer's references to its parameters, are left as they are."""
    if into is None:
        into = copy.deepcopy(model)
        for p in into.parameters():
            p.grad = None
            p.requires_grad_(False)
    for name, p in into.named_parameters():
        p.copy_(params[name])
    live = dict(model.named_buffers())
    for name, b in into.named_buffers():
        b.copy_(live[name])
    return into
