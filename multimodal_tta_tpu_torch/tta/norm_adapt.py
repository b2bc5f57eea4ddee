"""Statistic-only test-time adaptation (method "norm"; the port of
``multimodal_tta_tpu/tta/norm_adapt.py``).

The reference recomputes BatchNorm statistics from the test batch: one
training-mode forward (``train=True``), no parameter update, the running
statistics moved once (``0.9 * running + 0.1 * batch``; the padded rows of
a batch pool in). Episodic mode starts every batch from the source
statistics, continual mode carries them. ``restore()`` puts the source
statistics back. Models without batch statistics (the InstanceNorm ones)
pass through unchanged, with a warning, in both modes. Over ranks
(``mesh``) the statistics pool over the ranks' rows
(``models/layers.py:pool_over_ranks``), over a space axis the depth
slabs' too (``parallel/space.py``): every rank moves the same statistics.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..conf.node import ConfigNode
from ..models.layers import (
    batch_statistics,
    has_batch_statistics,
    load_running_statistics,
    pool_over_ranks,
    reject_torch_batchnorm,
    running_statistics,
)
from ..ops.intensity import make_intensity_normalizer
from ..parallel import space as sp
from ..registry import register_tta_method
from ..utils.config import get_config
from ..utils.logger import get_logger


@register_tta_method("norm")
class NormAdapter:
    method = "norm"

    def __init__(self, tta_cfg, config=None, device_transform=None, *, device: DeviceLike = "cuda", mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.parallel else None
        self.logger = get_logger()
        self.episodic = bool(get_config(tta_cfg or ConfigNode(), "episodic", True))
        self.last_entropy = None
        device_transform = device_transform or {}
        self._norm_fn = None
        if device_transform.get("normalize"):
            self._norm_fn = make_intensity_normalizer(
                normalize=True,
                intensity_policy=device_transform.get("intensity_policy"),
                channel_names=device_transform.get("channel_names"),
                mean=device_transform.get("mean"),
                std=device_transform.get("std"),
            )
        self._model = None
        self._source = {}

    def make_adapt_fn(self, source_model: nn.Module):
        reject_torch_batchnorm(source_model)
        pool_over_ranks(source_model, self.mesh)
        if not has_batch_statistics(source_model):
            self.logger.warning(
                "[norm] model has no batch statistics (InstanceNorm?); "
                "statistic adaptation is a no-op"
            )
            self._model, self._source = None, {}

            def identity(state, image, n_valid, ent_floor=None):
                return state

            return identity

        self._model = source_model
        self._source = running_statistics(source_model)

        @torch.no_grad()
        def adapt_fn(state, image, n_valid, ent_floor=None):
            if state is not self._model:
                raise ValueError("[norm] the state must be the model this function was built with")
            if self.episodic:
                load_running_statistics(state, self._source)
            image = torch.as_tensor(image).to(self.device, torch.float32)  # upcast compact transfer dtypes
            if self._norm_fn is not None:
                image = self._norm_fn(image, space=sp.axis_of(self.mesh))
            with sp.sharded(self.mesh), batch_statistics(state):
                state(image)
            return state

        return adapt_fn

    def restore(self) -> None:
        """The source running statistics back into the bound model."""
        if self._model is not None:
            load_running_statistics(self._model, self._source)
