"""Statistic-only test-time adaptation (method "norm"; the port of
``multimodal_tta_tpu/tta/norm_adapt.py``).

The reference recomputes BatchNorm statistics from the test batch — one
training-mode forward, no parameter update. Only models with batch
statistics have anything to adapt; InstanceNorm models, the only ones the
port builds so far, are stateless and pass through unchanged, with a
warning, in episodic and continual mode alike. The statistic recompute
comes with the BATCH norm (ROADMAP.md item 11).
"""

from __future__ import annotations

from torch import nn

from .. import DeviceLike, resolve_device
from ..conf.node import ConfigNode
from ..registry import register_tta_method
from ..utils.config import get_config
from ..utils.logger import get_logger


def has_batch_statistics(model: nn.Module) -> bool:
    """True when a module of ``model`` keeps running batch statistics."""
    return any(isinstance(m, nn.modules.batchnorm._NormBase) and m.track_running_stats
               for m in model.modules())


@register_tta_method("norm")
class NormAdapter:
    method = "norm"

    def __init__(self, tta_cfg, config=None, device_transform=None, *, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.logger = get_logger()
        self.episodic = bool(get_config(tta_cfg or ConfigNode(), "episodic", True))
        self.last_entropy = None

    def make_adapt_fn(self, source_model: nn.Module):
        if has_batch_statistics(source_model):
            raise NotImplementedError(
                "[norm] recomputing batch statistics needs the BATCH norm, which is not "
                "ported yet (ROADMAP.md item 11)")
        self.logger.warning(
            "[norm] model has no batch statistics (InstanceNorm?); "
            "statistic adaptation is a no-op"
        )

        def identity(state, image, n_valid, ent_floor=None):
            return state

        return identity

    def restore(self) -> None:
        """Nothing to put back: the identity leaves the model as it was."""
