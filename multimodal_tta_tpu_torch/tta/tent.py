"""Tent test-time adaptation (the port of ``multimodal_tta_tpu/tta/tent.py``).

Entropy minimization (Wang et al., "Tent", ICLR 2021) over sigmoid or
softmax outputs, with gradients reaching only the selected parameters
(by default the norm affines). Each batch: on-device intensity
normalization, K steps of forward + entropy + backward + optimizer update,
and optionally the thresholded segmentation:

  * ``predict="post"``   — an extra forward with the updated params (strict
                           adapt-then-predict, what evaluation uses);
  * ``predict="inline"`` — the last adaptation step's own forward (the
                           official online Tent protocol, one forward less).

Episodic mode resets the adapted params to their source values and starts
a fresh optimizer for every batch; continual mode carries both.

Where the reference threads a functional ``TrainState``, the port adapts the
model in place: ``make_*`` take the model, freeze every parameter outside
the adapted set (``requires_grad=False``), keep a copy of the adapted
params' source values, and the returned functions take and return that same
model as the ``state``.

Not ported in this slice (they raise ``NotImplementedError`` when enabled;
ROADMAP.md lists them): modality dropout, windowed adaptation, the
consistency and pseudo-label objectives, early stop, stochastic restore,
reliability gating and the Fisher anchor; the mesh (multi-GPU) path.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..conf.node import ConfigNode
from ..ops.intensity import make_intensity_normalizer
from ..ops.losses import entropy_loss
from ..registry import register_tta_method
from ..utils.config import get_config
from ..utils.logger import get_logger

_AFFINE = {"scale", "bias"}
_UNPORTED_EXTRAS = ("modality_dropout", "window", "early_stop", "restore", "reliability", "fisher")


def flax_path(name: str) -> str:
    """The reference's '/'-joined param path of a torch parameter name
    (``enc0.unit0.conv.weight`` -> ``enc0/unit0/conv/kernel``), which
    ``update_path_regex`` is matched against."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def norm_param_mask(model: nn.Module) -> Dict[str, bool]:
    """``{param name: is a norm-layer affine param}``.

    STRUCTURAL, as in the reference: a norm module is one whose parameters
    are exactly a 1-D ``scale`` and/or 1-D ``bias`` and nothing else — no
    other param, no child holding params. Conv modules fail it (they hold a
    ``weight``), whatever the module names are."""
    norm_modules = set()
    for mname, m in model.named_modules():
        direct = dict(m.named_parameters(recurse=False))
        has_param_children = any(
            any(True for _ in c.parameters()) for c in m.children()
        )
        if (
            direct
            and not has_param_children
            and set(direct) <= _AFFINE
            and all(p.dim() == 1 for p in direct.values())
        ):
            norm_modules.add(mname)
    return {
        name: name.rpartition(".")[0] in norm_modules
        for name, _ in model.named_parameters()
    }


@register_tta_method("tent")
class TentAdapter:
    """Builds ``adapt_fn(state, image, n_valid)`` and
    ``adapt_predict_fn(state, image, n_valid)`` closures over one model."""

    def __init__(self, tta_cfg, config=None, device_transform=None, *, device: DeviceLike = "cuda"):
        self.cfg = tta_cfg or ConfigNode()
        self.config = config or ConfigNode()
        self.device = resolve_device(device)
        self.logger = get_logger()

        self.steps = int(get_config(self.cfg, "steps", 1))
        self.lr = float(get_config(self.cfg, "lr", 1e-3))
        self.opt_name = str(get_config(self.cfg, "optimizer", "sgd")).lower()
        self.momentum = float(get_config(self.cfg, "momentum", 0.9))
        self.update = str(get_config(self.cfg, "update", "norm")).lower()
        self.update_regex = get_config(self.cfg, "update_path_regex", None)
        self.episodic = bool(get_config(self.cfg, "episodic", True))

        crit = get_config(self.config, "training.criterion", ConfigNode())
        softmax = bool(get_config(crit, "softmax", False))
        self.sigmoid_mode = bool(get_config(crit, "sigmoid", not softmax))

        self.predict_mode = str(get_config(self.cfg, "predict", "post")).lower()
        if self.predict_mode not in ("post", "inline"):
            raise ValueError(f"[tent] unknown predict mode: {self.predict_mode}")
        self.entropy_focus = str(get_config(self.cfg, "entropy_focus", "all")).lower()
        if self.entropy_focus not in ("all", "uncertain"):
            raise ValueError(f"[tent] unknown entropy_focus: {self.entropy_focus}")

        loss_mode = str(get_config(self.cfg, "loss", "entropy")).lower()
        if loss_mode not in ("entropy", "entropy+consistency", "pl", "pl+consistency"):
            raise ValueError(f"[tent] unknown loss mode: {loss_mode}")
        if loss_mode != "entropy":
            raise NotImplementedError(
                f"[tent] loss={loss_mode!r} is not ported yet (ROADMAP.md, Tent extras)"
            )
        for extra in _UNPORTED_EXTRAS:
            if bool(get_config(self.cfg, f"{extra}.enabled", False)):
                raise NotImplementedError(
                    f"[tent] tta.{extra} is not ported yet (ROADMAP.md, Tent extras)"
                )
        if not bool(get_config(self.cfg, "sync_over_mesh", True)):
            raise ValueError(
                "[tent] sync_over_mesh=false is not supported: the adapt step "
                "always pools over the batch"
            )

        self.device_transform = device_transform or {}
        self._norm_fn = None
        if self.device_transform.get("normalize"):
            self._norm_fn = make_intensity_normalizer(
                normalize=True,
                intensity_policy=self.device_transform.get("intensity_policy"),
                channel_names=self.device_transform.get("channel_names"),
                mean=self.device_transform.get("mean"),
                std=self.device_transform.get("std"),
            )

        self._model: Optional[nn.Module] = None
        self._trainable: List[nn.Parameter] = []
        self._source: List[torch.Tensor] = []
        self._opt: Optional[torch.optim.Optimizer] = None
        self._last_ents: Optional[torch.Tensor] = None

    @property
    def last_entropy(self) -> Optional[float]:
        """Final-step entropy of the most recent adaptation (read from the
        device on access, not per batch)."""
        if self._last_ents is None:
            return None
        return float(self._last_ents[-1])

    def _param_mask(self, model: nn.Module) -> Dict[str, bool]:
        """True = adapted. update=norm -> norm affine params; update=all ->
        all. ``update_path_regex`` further restricts either set to params
        whose reference path ('comp/comp/...') it matches."""
        if self.update == "norm":
            mask = norm_param_mask(model)
        elif self.update == "all":
            mask = {name: True for name, _ in model.named_parameters()}
        else:
            raise ValueError(f"[tent] unknown update mode: {self.update}")
        if self.update_regex:
            pat = re.compile(str(self.update_regex))
            mask = {k: m and bool(pat.search(flax_path(k))) for k, m in mask.items()}
        n = sum(mask.values())
        if n == 0:
            raise ValueError(
                f"[tent] no adapted parameters selected (update={self.update}, "
                f"update_path_regex={self.update_regex!r})"
            )
        obj_desc = ("self-normalized entropy (focus=uncertain)" if self.entropy_focus == "uncertain"
                    else "plain Tent entropy (focus=all)")
        self.logger.info(
            f"[tent] adapting {n} param tensors (of {len(mask)}), objective={obj_desc}"
            + (f" under path filter {self.update_regex!r}" if self.update_regex else "")
        )
        return mask

    def _build_opt(self) -> torch.optim.Optimizer:
        """Optimizer over the adapted params only. torch's SGD with
        dampening 0 is optax's ``sgd`` momentum trace; Adam's defaults are
        optax's."""
        if self.opt_name == "sgd":
            return torch.optim.SGD(self._trainable, lr=self.lr, momentum=self.momentum, dampening=0.0)
        if self.opt_name == "adam":
            return torch.optim.Adam(self._trainable, lr=self.lr)
        raise ValueError(f"[tent] unsupported optimizer: {self.opt_name}")

    def _bind(self, model: nn.Module) -> None:
        """Select and unfreeze the adapted params, freeze the rest, and keep
        the adapted params' source values for episodic resets."""
        for p in model.parameters():
            if p.device != self.device:
                raise ValueError(f"[tent] model is on {p.device}, adapter on {self.device}")
        mask = self._param_mask(model)
        self._model = model
        self._trainable = []
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name])
            if mask[name]:
                self._trainable.append(p)
        self._source = [p.detach().clone() for p in self._trainable]
        self._opt = self._build_opt()
        self._last_ents = None

    def _predict(self, logits: torch.Tensor, threshold: float) -> torch.Tensor:
        """Sigmoid mode thresholds per channel; softmax mode takes the
        channel argmax."""
        if self.sigmoid_mode:
            return (torch.sigmoid(logits) >= threshold).to(torch.uint8)
        return torch.argmax(logits, dim=-1, keepdim=True).to(torch.uint8)

    def _adapt(self, state: nn.Module, image: torch.Tensor, n_valid,
               threshold: Optional[float], predict_mode: str) -> Optional[torch.Tensor]:
        model = self._model
        if state is not model:
            raise ValueError("[tent] the state must be the model this function was built with")
        if self.episodic:
            with torch.no_grad():
                for p, s in zip(self._trainable, self._source):
                    p.copy_(s)
            self._opt = self._build_opt()
        opt = self._opt
        image = image.to(self.device, torch.float32)
        if self._norm_fn is not None:
            image = self._norm_fn(image)
        b = image.shape[0]
        w = (torch.arange(b, device=image.device) < n_valid).to(torch.float32)
        denom = torch.clamp(w.sum(), min=1.0)

        ents = []
        logits = None
        for _ in range(self.steps):
            logits = model(image)
            per_sample = entropy_loss(logits, sigmoid=self.sigmoid_mode,
                                      focus=self.entropy_focus, per_sample=True)
            loss = (per_sample * w).sum() / denom
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            ents.append(loss.detach())
        self._last_ents = torch.stack(ents)
        if threshold is None:
            return None
        if predict_mode == "inline":
            return self._predict(logits.detach(), threshold)
        with torch.no_grad():
            return self._predict(model(image), threshold)

    def make_adapt_fn(self, source_model: nn.Module) -> Callable:
        """``adapt_fn(state, image, n_valid) -> state``: adapts the model in
        place (from its source values in episodic mode) and returns it."""
        self._bind(source_model)

        def adapt_fn(state, image, n_valid):
            self._adapt(state, image, n_valid, None, "post")
            return state

        return adapt_fn

    def make_adapt_predict_fn(self, source_model: nn.Module, threshold: float,
                              predict_mode: Optional[str] = None) -> Callable:
        """``adapt_predict_fn(state, image, n_valid) -> (state, pred uint8)``:
        adaptation and segmentation in one call (the serving step).
        ``predict_mode`` defaults to ``tta.predict``."""
        mode = (predict_mode or self.predict_mode).lower()
        if mode not in ("post", "inline"):
            raise ValueError(f"[tent] unknown predict mode: {mode}")
        if mode == "inline" and self.episodic and self.steps == 1:
            self.logger.warning(
                "[tent] predict=inline with episodic=true, steps=1: "
                "predictions come from the pre-update forward and the "
                "state resets per batch, so adaptation cannot affect any "
                "prediction — use episodic=false (continual) or steps>1"
            )
        self._bind(source_model)
        thr = float(threshold)

        def adapt_predict_fn(state, image, n_valid):
            pred = self._adapt(state, image, n_valid, thr, mode)
            return state, pred

        return adapt_predict_fn
