"""Late-fusion multimodal UNet (the port of
``multimodal_tta_tpu/models/unet_multimodal_latefusion.py``).

  - ``unet_multimodal_late`` / ``unet_multimodal_latefusion``: one full
    ``UNet3D`` tower per modality (``tower{m}``, one input channel each),
    their logits averaged;
  - ``unet_multimodal_mid`` is an alias of the mid-fusion model.

At full width with 4 modalities: 328 parameter tensors, 144 of them norm
affines, 72 norm calls a forward. ``remat`` goes to every tower.

Over the space axis (``parallel/space.py``) each tower is a ``UNet3D`` on
this rank's depth slab of its modality, so the average is this slab's of
the whole logits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..registry import register_model
from ..utils.config import get_config
from .unet3d import UNet3D, finish_model
from .unet_multimodal_midfusion import MultimodalUNetMidFusion

register_model("unet_multimodal_mid")(MultimodalUNetMidFusion)


@register_model("unet_multimodal_late")
@register_model("unet_multimodal_latefusion")
class MultimodalUNetLateFusion(nn.Module):
    def __init__(
        self,
        num_modalities: int = 4,
        num_classes: int = 3,
        channels: Sequence[int] = (32, 64, 128, 256, 512),
        strides: Sequence[int] = (2, 2, 2, 2),
        num_res_units: int = 2,
        act: str = "RELU",
        norm: str = "INSTANCE",
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        remat=False,
        *,
        device: DeviceLike = "cuda",
        seed: Optional[int] = 0,
    ):
        super().__init__()
        resolve_device(device)
        self.num_modalities = int(num_modalities)
        self.num_classes = int(num_classes)
        for m in range(self.num_modalities):
            self.add_module(f"tower{m}", UNet3D(
                in_channels=1, num_classes=num_classes, channels=channels, strides=strides,
                num_res_units=num_res_units, act=act, norm=norm, dropout=dropout, dtype=dtype, remat=remat,
                device="cpu", seed=None))
        finish_model(self, seed, device)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "MultimodalUNetLateFusion":
        kw = dict(
            num_modalities=int(get_config(cfg, "num_modalities", 4)),
            num_classes=int(get_config(cfg, "num_classes", 3)),
            channels=tuple(int(c) for c in get_config(cfg, "channels", [32, 64, 128, 256, 512])),
            strides=tuple(int(s) for s in get_config(cfg, "strides", [2, 2, 2, 2])),
            num_res_units=int(get_config(cfg, "num_res_units", 2)),
            act=str(get_config(cfg, "act", "RELU")),
            norm=str(get_config(cfg, "norm", "INSTANCE")),
            dropout=float(get_config(cfg, "dropout", 0.0)),
        )
        kw.update(overrides)
        return cls(**kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, D, H, W, M] -> averaged logits [B, D, H, W, num_classes] (f32)."""
        if x.shape[-1] != self.num_modalities:
            raise ValueError(f"Expected {self.num_modalities} modalities, got {x.shape[-1]} channels")
        logits = None
        for m in range(self.num_modalities):
            out = getattr(self, f"tower{m}")(x[..., m:m + 1])
            logits = out if logits is None else logits + out
        return logits / self.num_modalities
