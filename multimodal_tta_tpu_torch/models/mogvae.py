"""Mixture-of-Gaussians VAE delta generator, ``vae_delta_mog`` (the port of
``multimodal_tta_tpu/models/mogvae.py``; nothing calls it, in the reference
either: it stays registered for the API's completeness).

A conv variational autoencoder whose latent takes a K-component
mixture-of-Gaussians soft reparameterisation

    z = mu + exp(logvar / 2) * eps_post + sum_k pi_k * (mu_k + softplus(logsig_k) * eps_k),
    pi = softmax(logpi [+ gate(x)])

and whose decoder emits an unconstrained delta map (the caller applies the
L-inf / pixel-box projection). NHWC in and out; inside, NCHW views of NHWC
memory. Module names are flax's (``enc{i}``, ``mu``, ``logvar``, ``mu_k``,
``logsig_k``, ``logpi``, ``gate_h``, ``gate_out``, ``unflatten``, ``dec{i}``,
``head``), so ``models/convert.py`` carries the reference's params across.

Random numbers: the reference draws ``eps_post`` [B, L] and ``eps_k``
[B, K, L] from a threefry key (``PRNGKey(0)`` without one); the port takes
them as tensors (``reparam_draws`` makes them from an explicit
``torch.Generator``, one seeded 0 on the input's device without one).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike, resolve_device
from ..registry import register_model
from ..utils.config import get_config
from .layers import conv3d_same
from .resnet import finish_classifier


@register_model("vae_delta_mog")
class VAEDeltaMoG(nn.Module):
    """x: [B, H, W, in_channels] -> (delta [B, H, W, out_channels], aux with
    ``mu``, ``logvar``, ``pi`` and ``z`` for the KL term)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 1, latent_size: int = 128,
                 channels: Sequence[int] = (32, 64, 128, 256, 512), strides: Sequence[int] = (2, 2, 2, 2),
                 image_size: Sequence[int] = (64, 64), mog_k: int = 16, use_gate: bool = False,
                 gate_hidden: int = 256, dtype: torch.dtype = torch.float32, *, device: DeviceLike = "cuda",
                 seed: Optional[int] = 0):
        super().__init__()
        resolve_device(device)
        self.in_channels, self.latent_size, self.mog_k = int(in_channels), int(latent_size), int(mog_k)
        self.strides, self.dtype, self.use_gate = tuple(int(s) for s in strides), dtype, bool(use_gate)
        self.image_size = tuple(int(s) for s in image_size)
        cin, (h, w) = self.in_channels, self.image_size
        for i, (feat, s) in enumerate(zip(channels[:len(self.strides)], self.strides)):
            self.add_module(f"enc{i}", nn.Conv2d(cin, int(feat), 3, s))
            cin, h, w = int(feat), -(-h // s), -(-w // s)  # "SAME": ceil(n / s)
        self.bottleneck = (cin, h, w)
        self.mu = nn.Linear(cin * h * w, self.latent_size)
        self.logvar = nn.Linear(cin * h * w, self.latent_size)
        self.mu_k = nn.Parameter(torch.zeros(self.mog_k, self.latent_size))
        self.logsig_k = nn.Parameter(torch.zeros(self.mog_k, self.latent_size))
        self.logpi = nn.Parameter(torch.zeros(self.mog_k))
        if self.use_gate:
            self.gate_h = nn.Linear(cin, int(gate_hidden))
            self.gate_out = nn.Linear(int(gate_hidden), self.mog_k)

        down = 1
        for s in self.strides:
            down *= s
        self.h0, self.w0 = self.image_size[0] // down, self.image_size[1] // down
        cin = self.feat0 = int(channels[len(self.strides) - 1])
        self.unflatten = nn.Linear(self.latent_size, self.h0 * self.w0 * self.feat0)
        for i, s in enumerate(reversed(self.strides)):
            feat = int(channels[max(0, len(self.strides) - 2 - i)])
            self.add_module(f"dec{i}", nn.ConvTranspose2d(cin, feat, s, s))
            cin = feat
        self.head = nn.Conv2d(cin, int(out_channels), 3, 1)
        finish_classifier(self, seed, device)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "VAEDeltaMoG":
        kw = dict(
            in_channels=int(get_config(cfg, "in_channels", 3)),
            out_channels=int(get_config(cfg, "out_channels", 1)),
            latent_size=int(get_config(cfg, "latent_size", 128)),
            channels=tuple(int(c) for c in get_config(cfg, "channels", [32, 64, 128, 256, 512])),
            strides=tuple(int(s) for s in get_config(cfg, "strides", [2, 2, 2, 2])),
            image_size=tuple(int(s) for s in get_config(cfg, "image_size", [64, 64])),
            mog_k=int(get_config(cfg, "mog.K", 16)),
            use_gate=bool(get_config(cfg, "mog.use_gate", False)),
            gate_hidden=int(get_config(cfg, "mog.gate_hidden", 256)),
        )
        kw.update(overrides)
        kw.pop("remat", None)
        return cls(**kw)

    def reparam_draws(self, b: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(eps_post [b, latent_size], eps_k [b, mog_k, latent_size])``,
        standard normal, on the generator's device."""
        eps_post = torch.randn((b, self.latent_size), generator=generator, device=generator.device)
        eps_k = torch.randn((b, self.mog_k, self.latent_size), generator=generator, device=generator.device)
        return eps_post, eps_k

    def forward(self, x: torch.Tensor, eps_post: Optional[torch.Tensor] = None,
                eps_k: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The draws not given are taken from ``generator`` (one seeded 0 on
        the input's device when that is None too)."""
        b = x.shape[0]
        if x.dim() != 4 or x.shape[-1] != self.in_channels:
            raise ValueError(f"expected NHWC input with {self.in_channels} channels, got {tuple(x.shape)}")
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(len(self.strides)):
            h = F.relu(conv3d_same(h, getattr(self, f"enc{i}"), self.dtype))
        if tuple(h.shape[1:]) != self.bottleneck:
            raise ValueError(f"input {tuple(x.shape)} gives a bottleneck {tuple(h.shape[1:])}; image_size "
                             f"{self.image_size} gives {self.bottleneck}")
        flat = h.permute(0, 2, 3, 1).reshape(b, -1).float()  # the reference flattens NHWC
        mu = F.linear(flat, self.mu.weight, self.mu.bias)
        logvar = F.linear(flat, self.logvar.weight, self.logvar.bias)

        mix_logits = self.logpi.expand(b, self.mog_k)
        if self.use_gate:
            pooled = h.float().mean(dim=(2, 3)).to(h.dtype).float()
            g = F.relu(F.linear(pooled, self.gate_h.weight, self.gate_h.bias))
            mix_logits = mix_logits + F.linear(g, self.gate_out.weight, self.gate_out.bias)
        pi = torch.softmax(mix_logits, dim=-1)  # [B, K]

        if eps_post is None or eps_k is None:
            gen = generator or torch.Generator(device=x.device).manual_seed(0)
            draws = self.reparam_draws(b, gen)
            eps_post = draws[0] if eps_post is None else eps_post
            eps_k = draws[1] if eps_k is None else eps_k
        z_post = mu + torch.exp(0.5 * logvar) * eps_post.to(mu.device)  # the standard VAE sample
        comp = self.mu_k[None] + F.softplus(self.logsig_k)[None] * eps_k.to(mu.device)  # [B, K, L]
        z = z_post + torch.sum(pi[:, :, None] * comp, dim=1)  # plus the soft mixture sample

        h = F.linear(z, self.unflatten.weight, self.unflatten.bias).reshape(b, self.h0, self.w0, self.feat0)
        h = h.to(self.dtype).permute(0, 3, 1, 2)
        for i, s in enumerate(reversed(self.strides)):
            dec = getattr(self, f"dec{i}")
            h = F.relu(F.conv_transpose2d(h, dec.weight.to(self.dtype), dec.bias.to(self.dtype), stride=s))
        delta = conv3d_same(h.float(), self.head, torch.float32)
        return delta.permute(0, 2, 3, 1), {"mu": mu, "logvar": logvar, "pi": pi, "z": z}


__all__ = ["VAEDeltaMoG"]
