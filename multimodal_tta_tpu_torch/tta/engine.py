"""TTA evaluation engine (the port of ``multimodal_tta_tpu/tta/engine.py``).

Uniform runner for the adaptation modes:
  - "none":     plain inference (source model, no adaptation)
  - a method:   any registered one (tent, pl, eata, norm, sar, cotta, memo),
                episodic (adapt from source weights on every batch) or
                continual (episodic=false: the adapted state streams across
                batches/domains)

The engine wraps an evaluation strategy: adaptation plugs into the
strategy's per-batch hook, so metric schema and per-domain aggregation are
identical with and without TTA.

The reference's ``evaluate`` is functional: the caller's state is what it
was afterwards. The port's adapters change the model in place, so
``evaluate`` restores the adapted parameters to their source values, and
resets what the method carries (momentum, SAR's entropy EMA, CoTTA's
teacher), before it returns, also when the loop raises — a second ``evaluate``, or a
following no-adaptation run, scores the source model as the reference does.

Over ranks (``mesh``, ``parallel/mesh.py``) each rank adapts and scores its
rows of every batch, and ``evaluate`` returns on every rank the metrics one
process returns for the global batches. Every method runs over the data
axis and over a space axis (each rank adapting on its depth slab of its
rows, ``tta/tent.py``).

``classifier_logits_apply`` bridges the 2D classification backbones'
``(features, logits)`` contract to the adapters, which take a model whose
forward returns the logits.
"""

from __future__ import annotations

import copy
from typing import Dict

from torch import nn

from .. import DeviceLike, resolve_device
from ..conf.node import ConfigNode
from ..registry import get_evaluation_strategy, get_tta_method
from ..utils.config import get_config
from ..utils.logger import get_logger

class TTAEngine:
    def __init__(self, config, device_transform=None, strategy=None, *, device: DeviceLike = "cuda", mesh=None):
        self.config = config
        self.device = resolve_device(device)
        self.logger = get_logger()
        self.mesh = mesh if mesh is not None and mesh.parallel else None

        self.tta_cfg = get_config(config, "tta", ConfigNode())
        self.method = str(get_config(self.tta_cfg, "method", "none")).lower()

        if strategy is None:
            name = get_config(config, "task.eval_strategy", "seg_eval")
            strategy = get_evaluation_strategy(name)(config)
        self.strategy = strategy
        self.device_transform = device_transform

        self.adapter = None
        if self.method not in ("none", ""):
            adapter_cls = get_tta_method(self.method)
            self.adapter = adapter_cls(
                self.tta_cfg,
                config=config,
                device_transform=device_transform,
                device=self.device,
                mesh=self.mesh,
            )

    @property
    def episodic(self) -> bool:
        return self.adapter.episodic if self.adapter is not None else True

    def evaluate(self, state: nn.Module, data_loader) -> Dict[str, float]:
        """Run (adapt +) evaluate over the loader; returns the seg_eval
        metric dict. The model's parameters are left as they were."""
        if self.adapter is None:
            return self.strategy.evaluate_epoch(state, data_loader, device=self.device, mesh=self.mesh)

        adapt_fn = self.adapter.make_adapt_fn(state)
        try:
            return self.strategy.evaluate_epoch(
                state,
                data_loader,
                adapt_fn=adapt_fn,
                carry_state=not self.adapter.episodic,
                device=self.device,
                mesh=self.mesh,
            )
        finally:
            self.adapter.restore()


def classifier_logits_apply(model: nn.Module) -> nn.Module:
    """A classifier whose forward returns the logits of ``model``'s
    ``(features, logits)`` (the registry's resnet / densenet / efficientnet /
    vit backbones), for any adapter: ``TentAdapter(...).make_adapt_fn(
    classifier_logits_apply(model))`` and the same for pl, eata, norm, sar,
    cotta and memo, whose BatchNorm branches recompute the running
    statistics from the test batch (for a classifier under covariate shift
    most of Tent's value).

    The wrapper is a shallow copy of ``model`` with another forward: it
    shares the backbone's parameters, buffers and submodules under their own
    names (no submodule prefix, so ``update_path_regex`` and the structural
    norm mask see the backbone's names), and adapting it adapts ``model``.
    Its own mode flag starts as ``model``'s."""
    wrapper = copy.copy(model)
    wrapper.__class__ = type(f"{type(model).__name__}Logits", (_LogitsOnly, type(model)), {})
    return wrapper


class _LogitsOnly:
    def forward(self, x):
        return super().forward(x)[1]
