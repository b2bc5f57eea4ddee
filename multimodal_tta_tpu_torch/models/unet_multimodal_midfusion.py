"""Multimodal UNet with per-modality encoders and residual bottleneck fusion
(the port of ``multimodal_tta_tpu/models/unet_multimodal_midfusion.py``),
registered as ``unet_multimodal_midfusion`` and ``unet_multimodal_deepfusion``.

  - one ``SpecificEncoder`` per modality (5 ResidualUnit stages, strides
    [2,2,2,2,1]) on its own channel, returning the bottleneck, its global
    mean and the skips;
  - the pseudo-shared bottleneck is the mean of the per-modality ones; ONE
    ``CompositionalLayer`` (one set of params) fuses it with each modality
    in turn (``shared + ConvBlock(cat(shared, specific))``), so its norm
    runs M times a forward and its gradient sums the M uses;
  - the fused features are concatenated and reduced by a 1x1x1 conv;
  - the decoder's skips are the means over modalities, the last the mean of
    the raw input, all in the compute dtype;
  - with ``domain_classifier.enabled`` a Dense(C -> M) in f32 over the
    per-modality global features, concatenated modality-major along the
    batch (row ``m * B + b``); it exists whatever the call flags.

Remat covers each encoder and each fusion and decoder stage. At full width
(channels 32..512, two subunits) the model has 208 parameter tensors, 98 of
them norm affines, and a forward makes 52 norm calls: 40 in the encoders, 4
in the fusion, 8 in the decoder. ``forward`` takes and returns NDHWC.

Over the space axis (``parallel/space.py``) ``x`` is this rank's depth
slab; the encoders and the shared path follow the flagship's rule
(``space.level_axes``; a stage whose output level is whole takes its input
gathered, an ``UpSample`` into a split level keeps its slab of the repeat),
and ``_spatial_mean`` sums over the space group with its gradient and
divides by the whole volume's count.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..registry import register_model
from ..utils.config import get_config
from ..parallel import space as sp
from .layers import ConvBlock, ResidualUnit, UpSample, conv3d_same, head_linear, remat_call
from .unet3d import finish_model


def _mean(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.mean(jnp.stack(tensors), 0)`` of compute-dtype tensors: an f32
    sum, then the cast back, as JAX does for a bf16 mean."""
    acc = tensors[0].float()
    for t in tensors[1:]:
        acc = acc + t.float()
    return (acc / len(tensors)).to(tensors[0].dtype)


def _spatial_mean(h: torch.Tensor, space=None) -> torch.Tensor:
    """Mean over D, H, W of [B, C, D, H, W]: f32 sum, cast back. Over a split
    depth (``space``) the slabs' sums meet, with their gradient, and the
    count is the whole volume's."""
    if space is None:
        return h.float().mean(dim=(2, 3, 4)).to(h.dtype)
    total = sp.space_sum(h.float().sum(dim=(2, 3, 4)), space, grad=True)
    return (total / float(h[0, 0].numel() * space.size)).to(h.dtype)


class SpecificEncoder(nn.Module):
    def __init__(self, in_features: int, channels: Sequence[int], strides: Sequence[int], num_res_units: int,
                 act: str, norm: str, dropout: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = len(channels)
        strides = list(strides) + [1]
        cin = in_features
        for i, (feat, s) in enumerate(zip(channels, strides)):
            self.add_module(f"layer{i}", ResidualUnit(cin, feat, s, subunits=num_res_units, norm=norm,
                                                      act=act, dropout=dropout, dtype=dtype))
            cin = feat

    def forward(self, x: torch.Tensor, axes=None) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        """x [B,1,D,H,W] -> (bottleneck, global feature [B,C], skips);
        ``axes``: each level's space axis (None where it is whole)."""
        axes = axes or [None] * (self.n_layers + 1)
        skips = []
        h = x
        for i in range(self.n_layers):
            if axes[i] is not None and axes[i + 1] is None:
                h = sp.gather_depth(h, axes[i])  # the stage's output level is whole
            h = getattr(self, f"layer{i}")(h, axes[i + 1])
            if i < self.n_layers - 1:
                skips.append(h)
        return h, _spatial_mean(h, axes[-1]), skips


class CompositionalLayer(nn.Module):
    """Residual fusion at the bottleneck: shared + ConvBlock(cat(shared, specific))."""

    def __init__(self, features: int, norm: str, act: str, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fusion_conv = ConvBlock(2 * features, features, 3, 1, norm, act, dtype=dtype)

    def forward(self, f_shared: torch.Tensor, f_specific: torch.Tensor, space=None) -> torch.Tensor:
        return f_shared + self.fusion_conv(torch.cat([f_shared, f_specific], dim=1), space)


class DecoderStage(nn.Module):
    """UpSample + concat skip + ResidualUnit."""

    def __init__(self, in_features: int, skip_features: int, features: int, stride: int, num_res_units: int,
                 act: str, norm: str, dropout: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.upsample = UpSample(in_features, features, stride, dtype=dtype)
        self.conv = ResidualUnit(features + skip_features, features, 1, subunits=num_res_units, norm=norm,
                                 act=act, dropout=dropout, dtype=dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, space=None, slice_to=None) -> torch.Tensor:
        """``space``: the output level's space axis; ``slice_to``: the same
        axis when ``x``'s level is whole and the output's split."""
        return self.conv(torch.cat([self.upsample(x, slice_to), skip], dim=1), space)


@register_model("unet_multimodal_deepfusion")
@register_model("unet_multimodal_midfusion")
class MultimodalUNetMidFusion(nn.Module):
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
        domain_enabled: bool = True,
        domain_loss_weight: float = 0.1,
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
        self.channels = tuple(int(c) for c in channels)
        self.strides = tuple(int(s) for s in strides)
        self.domain_enabled = bool(domain_enabled)
        self.domain_loss_weight = float(domain_loss_weight)
        self.dtype = dtype
        self.remat = bool(remat)
        chs, sts = self.channels, self.strides
        for m in range(self.num_modalities):
            self.add_module(f"specific_encoder{m}", SpecificEncoder(1, chs, sts, num_res_units, act, norm,
                                                                    dropout, dtype=dtype))
        self.fusion_layer = CompositionalLayer(chs[-1], norm, act, dtype=dtype)
        self.bottleneck_reduce = nn.Conv3d(self.num_modalities * chs[-1], chs[-1], 1, bias=False)
        # decoder: [skip 2 @ R/8, skip 1 @ R/4, skip 0 @ R/2, input mean @ R]
        dec_feats = [chs[3], chs[2], chs[1], chs[0]]
        skip_feats = [chs[2], chs[1], chs[0], 1]
        dec_strides = [sts[3], sts[2], sts[1], sts[0]]
        cin = chs[-1]
        for i, (feat, sk, s) in enumerate(zip(dec_feats, skip_feats, dec_strides)):
            self.add_module(f"decoder{i}", DecoderStage(cin, sk, feat, s, num_res_units, act, norm, dropout,
                                                        dtype=dtype))
            cin = feat
        self.final_conv = nn.Conv3d(chs[0], self.num_classes, 1, bias=True)
        self.domain_classifier = nn.Linear(chs[-1], self.num_modalities) if self.domain_enabled else None
        finish_model(self, seed, device)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "MultimodalUNetMidFusion":
        domain_cfg = get_config(cfg, "domain_classifier", {})
        kw = dict(
            num_modalities=int(get_config(cfg, "num_modalities", 4)),
            num_classes=int(get_config(cfg, "num_classes", 3)),
            channels=tuple(int(c) for c in get_config(cfg, "channels", [32, 64, 128, 256, 512])),
            strides=tuple(int(s) for s in get_config(cfg, "strides", [2, 2, 2, 2])),
            num_res_units=int(get_config(cfg, "num_res_units", 2)),
            act=str(get_config(cfg, "act", "RELU")),
            norm=str(get_config(cfg, "norm", "INSTANCE")),
            dropout=float(get_config(cfg, "dropout", 0.0)),
            domain_enabled=bool(get_config(domain_cfg, "enabled", True)),
            domain_loss_weight=float(get_config(domain_cfg, "loss_weight", 0.1)),
        )
        kw.update(overrides)
        return cls(**kw)

    def get_domain_loss_weight(self) -> float:
        return self.domain_loss_weight if self.domain_enabled else 0.0

    def forward(self, x: torch.Tensor, *, return_domain_logits: bool = False,
                return_intermediate_features: bool = False):
        """x: [B, D, H, W, M] -> logits [B, D, H, W, num_classes] (f32), plus
        the domain logits [M*B, M] or the intermediate features
        (M x the shared global feature, the M specific ones) when asked and
        the domain head is enabled."""
        M = self.num_modalities
        if x.shape[-1] != M:
            raise ValueError(f"Expected {M} modalities, got {x.shape[-1]} channels")
        space = sp.current()
        # each level's axis (None where it is whole): the encoders' levels
        # 0..5, strides then the stride-1 bottleneck stage
        axes = sp.level_axes(space, x.shape[1], list(self.strides) + [1])
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3)  # NCDHW view of NDHWC memory

        feats, globs, all_skips = [], [], []
        for m in range(M):
            xm = x[:, m:m + 1].contiguous(memory_format=torch.channels_last_3d)
            feat, glob, skips = remat_call(getattr(self, f"specific_encoder{m}"), xm, axes, enabled=self.remat)
            feats.append(feat)
            globs.append(glob)
            all_skips.append(skips)

        shared = _mean(feats)
        fused = [remat_call(self.fusion_layer, shared, f, axes[-1], enabled=self.remat) for f in feats]
        h = conv3d_same(torch.cat(fused, dim=1), self.bottleneck_reduce, self.dtype, axes[-1])

        fused_skips = [_mean([sk[i] for sk in all_skips]) for i in range(len(all_skips[0]))]
        input_mean = _mean([x[:, m:m + 1] for m in range(M)])
        for i, skip in enumerate([fused_skips[2], fused_skips[1], fused_skips[0], input_mean]):
            # decoder i: level 4 - i up to level 3 - i
            slice_to = space if axes[4 - i] is None and axes[3 - i] is not None else None
            h = remat_call(getattr(self, f"decoder{i}"), h, skip, axes[3 - i], slice_to, enabled=self.remat)

        logits = head_linear(h, self.final_conv)
        if self.domain_classifier is None:
            return logits
        if return_intermediate_features:
            shared_glob = _spatial_mean(shared, axes[-1])
            return logits, [shared_glob] * M, globs
        if return_domain_logits:
            stacked = torch.cat(globs, dim=0).float()  # [M*B, C], row m*B + b
            return logits, self.domain_classifier(stacked)
        return logits
