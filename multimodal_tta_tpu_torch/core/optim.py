"""Optimizer and learning-rate schedule factories over ``torch.optim`` (the
port of ``multimodal_tta_tpu/core/optim.py``).

The reference's optimizer surface: sgd/adam/adamw selected by
``training.optimizer``, per-optimizer kwarg blocks under
``training.optimizers.<name>``, weight decay excluded for bias/norm/1-D
params per ``training.param_groups`` rules (two param groups here), and the
epoch-stepped ``EpochScheduler`` (plain Python, the reference's word for
word). Each update rule is the torch optimizer that equals the reference's
optax chain:

  * sgd   — ``add_decayed_weights`` + ``optax.sgd`` (trace, nesterov):
            ``torch.optim.SGD(weight_decay=, momentum=, dampening=0)``
  * adam  — decay added to the gradient (L2) + ``optax.adam``:
            ``torch.optim.Adam(weight_decay=)``
  * adamw — ``optax.adamw`` (decoupled decay): ``torch.optim.AdamW``

``training.grad_accum = k`` wraps the optimizer in ``MultiSteps``, the
counterpart of ``optax.MultiSteps``: the running mean of k gradients is
applied once every k-th step, and the inner optimizer's state (Adam's
count included) moves only then. The learning rate is a param-group value
that the trainer sets per epoch (``set_learning_rate``), as the reference
injects it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..conf.node import ConfigNode
from ..models.convert import flax_path
from ..utils.config import get_config


def no_decay_mask(model: nn.Module, no_decay_keys, treat_1d: bool = True) -> Dict[str, bool]:
    """``{param name: weight decay APPLIES}``.

    A param is excluded from decay when any configured key is a substring of
    its path, or when it is 1-D (bias/scale) and treat_1d is set — the
    reference's rules, decided on the flax path that ``models/convert.py``
    maps each torch parameter to (``...conv.weight`` is ``.../conv/kernel``),
    not on the torch name."""
    keys = [str(k).lower() for k in (no_decay_keys or [])]

    def decide(name: str, p: torch.Tensor) -> bool:
        path = flax_path(name).lower()
        if any(k in path for k in keys):
            return False
        if treat_1d and p.dim() <= 1:
            return False
        return True

    return {name: decide(name, p) for name, p in model.named_parameters()}


class MultiSteps:
    """Gradient accumulation over a torch optimizer (``optax.MultiSteps``
    with ``use_grad_mean``): each ``step()`` folds the params' ``.grad`` into
    a running mean ``acc + (g - acc) / (n + 1)``; the k-th hands the mean to
    the inner optimizer, steps it and resets. ``step()`` returns whether the
    params were updated."""

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int):
        self.optimizer = optimizer
        self.every_k = int(every_k)
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    @property
    def param_groups(self) -> List[Dict[str, Any]]:
        return self.optimizer.param_groups

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> bool:
        params = self._params()
        if self.acc is None:
            self.acc = [torch.zeros_like(p) for p in params]
        n = self.mini_step
        for p, a in zip(params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            a.add_((g - a) / (n + 1))
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step != 0:
            return False
        for p, a in zip(params, self.acc):
            p.grad = a.clone()
            a.zero_()
        self.optimizer.step()
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"inner": self.optimizer.state_dict(), "mini_step": self.mini_step,
                "acc": None if self.acc is None else [a.clone() for a in self.acc]}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(sd["inner"])
        self.mini_step = int(sd["mini_step"])
        acc = sd.get("acc")
        self.acc = None if acc is None else [
            a.to(device=p.device, dtype=p.dtype).clone() for a, p in zip(acc, self._params())]


Optimizer = Union[torch.optim.Optimizer, MultiSteps]


def build_optimizer(training_cfg, model: nn.Module) -> Tuple[Optimizer, float]:
    """Build the optimizer over ``model``'s trainable params; returns
    ``(optimizer, base_lr)``."""
    opt_name = str(get_config(training_cfg, "optimizer", "sgd")).lower()
    if opt_name == "adafactor":
        raise NotImplementedError(
            "[optim] adafactor is not ported yet (ROADMAP.md, training slice left-overs)"
        )
    if opt_name not in ("sgd", "adam", "adamw"):
        raise ValueError(f"Unsupported optimizer: {opt_name}")
    blocks = get_config(training_cfg, "optimizers", ConfigNode())
    opt_cfg = get_config(blocks, opt_name, ConfigNode())

    lr = float(get_config(opt_cfg, "lr", get_config(training_cfg, "learning_rate", 1e-3)))
    wd = float(get_config(opt_cfg, "weight_decay", get_config(training_cfg, "weight_decay", 0.0)))

    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if wd > 0:
        pg = get_config(training_cfg, "param_groups", ConfigNode())
        mask = no_decay_mask(model, get_config(pg, "no_decay_keys", []),
                             bool(get_config(pg, "treat_1d_as_no_decay", True)))
        groups = [{"params": [p for n, p in params if mask[n]], "weight_decay": wd},
                  {"params": [p for n, p in params if not mask[n]], "weight_decay": 0.0}]
        groups = [g for g in groups if g["params"]]
    else:
        groups = [{"params": [p for _, p in params], "weight_decay": 0.0}]

    if opt_name == "sgd":
        momentum = float(get_config(opt_cfg, "momentum", get_config(training_cfg, "momentum", 0.0)))
        nesterov = bool(get_config(opt_cfg, "nesterov", False)) and momentum > 0
        tx: torch.optim.Optimizer = torch.optim.SGD(
            groups, lr=lr, momentum=momentum, dampening=0.0, nesterov=nesterov)
    else:
        betas = get_config(opt_cfg, "betas", [0.9, 0.999])
        eps = float(get_config(opt_cfg, "eps", 1e-8))
        cls = torch.optim.Adam if opt_name == "adam" else torch.optim.AdamW
        tx = cls(groups, lr=lr, betas=(float(betas[0]), float(betas[1])), eps=eps)

    accum = int(get_config(training_cfg, "grad_accum", 1))
    if accum < 1:
        raise ValueError(f"training.grad_accum must be >= 1, got {accum}")
    if accum > 1:
        return MultiSteps(tx, accum), lr
    return tx, lr


def set_learning_rate(optimizer: Optimizer, lr: float) -> Optimizer:
    """Set the learning rate of every param group (through ``MultiSteps``)."""
    for g in optimizer.param_groups:
        g["lr"] = float(lr)
    return optimizer


def get_learning_rate(optimizer: Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class EpochScheduler:
    """Epoch-indexed LR schedule with the reference's scheduler vocabulary
    (reference: src/core/experiment_manager.py:275-316)."""

    def __init__(self, training_cfg, base_lr: float):
        sched_cfg = get_config(training_cfg, "scheduler", ConfigNode())
        self.name = str(get_config(sched_cfg, "name", "none")).lower()
        args = get_config(sched_cfg, "args", ConfigNode())
        self.base_lr = float(base_lr)
        self.epochs = int(get_config(training_cfg, "epochs", 200))

        self.milestones = [int(m) for m in get_config(args, "milestones", get_config(training_cfg, "milestones", [100, 150]))]
        self.gamma = float(get_config(args, "gamma", get_config(training_cfg, "gamma", 0.1)))
        self.step_size = int(get_config(args, "step_size", get_config(training_cfg, "step_size", 30)))
        # "poly": the nnU-Net standard for these workloads —
        # lr * (1 - epoch/epochs)^power, power 0.9
        self.power = float(get_config(args, "power", get_config(training_cfg, "power", 0.9)))
        # linear warmup over the first N epochs: lr * (e+1)/N, composing
        # with ANY schedule name (including "none") — the schedule's own
        # index keeps running during warmup, warmup just caps the ramp
        self.warmup_epochs = int(get_config(args, "warmup_epochs",
                                            get_config(training_cfg, "warmup_epochs", 0)))

        rop = get_config(args, "reduce_on_plateau", get_config(training_cfg, "reduce_on_plateau", ConfigNode()))
        self.rop_factor = float(get_config(rop, "factor", 0.1))
        self.rop_patience = int(get_config(rop, "patience", 10))
        self.rop_min_lr = float(get_config(rop, "min_lr", 1e-7))
        self._rop_best = float("inf")
        self._rop_bad = 0
        self._rop_lr = self.base_lr

    @property
    def enabled(self) -> bool:
        return self.name not in ("none", "") or self.warmup_epochs > 0

    def lr_for_epoch(self, epoch: int, val_loss: Optional[float] = None) -> float:
        """LR to use for epoch ``epoch`` (0-based), stepped per epoch."""
        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            return self.base_lr * (epoch + 1) / self.warmup_epochs
        if self.name in ("none", ""):
            return self.base_lr
        if self.name == "poly":
            t = min(epoch, self.epochs) / max(1, self.epochs)
            return self.base_lr * (1.0 - t) ** self.power
        if self.name == "multistep":
            k = sum(1 for m in self.milestones if epoch >= m)
            return self.base_lr * (self.gamma ** k)
        if self.name == "step":
            return self.base_lr * (self.gamma ** (epoch // self.step_size))
        if self.name == "cosine":
            t = min(epoch, self.epochs) / max(1, self.epochs)
            return 0.5 * self.base_lr * (1 + math.cos(math.pi * t))
        if self.name == "reduce_on_plateau":
            if val_loss is not None:
                if val_loss < self._rop_best:
                    self._rop_best = val_loss
                    self._rop_bad = 0
                else:
                    self._rop_bad += 1
                    if self._rop_bad > self.rop_patience:
                        self._rop_lr = max(self._rop_lr * self.rop_factor, self.rop_min_lr)
                        self._rop_bad = 0
            return self._rop_lr
        # unknown names -> no scheduling (same leniency as the reference)
        return self.base_lr

    def state_dict(self) -> Dict[str, Any]:
        return {
            "rop_best": self._rop_best,
            "rop_bad": self._rop_bad,
            "rop_lr": self._rop_lr,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._rop_best = float(sd.get("rop_best", float("inf")))
        self._rop_bad = int(sd.get("rop_bad", 0))
        self._rop_lr = float(sd.get("rop_lr", self.base_lr))
