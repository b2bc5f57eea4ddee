"""CoTTA-style EMA-teacher test-time adaptation (method "cotta"; the port of
``multimodal_tta_tpu/tta/cotta.py``).

The teacher half of CoTTA (Wang et al., "Continual Test-Time Domain
Adaptation", CVPR 2022 — public method): the objective is cross-entropy of
the STUDENT's predictions against soft pseudo-labels from an EMA TEACHER,
averaged over ``n_views`` views of the batch. View 0 is clean; each other
view gets an intensity scale/shift, additive Gaussian noise and a mirror
flip (cycled through the non-empty spatial-axis subsets, inverted exactly
in probability space). After each student update comes the stochastic
restore (``tta.restore``), then the teacher follows with momentum ``ema``.

The teacher holds only the adapted tensors; its forward is
``torch.func.functional_call`` of the model with the teacher's values, under
``no_grad``. The views run one after another and only the running sum of
their probabilities is kept, so no two views' activations are held at once.
``serve`` picks the served prediction: the view-averaged teacher
probabilities ("teacher") or the student ("student"). The entropy trace is
the student's self-normalized prediction entropy.

On a BatchNorm model the teacher runs in inference mode on the running
statistics the student carries into the step (``functional_call`` swaps
the adapted params only, and moves no statistics); the student's forward
runs on the batch's statistics and moves the running statistics once a
step; a post-update student prediction runs on the batch's statistics and
moves nothing, as in the reference.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from ..ops.augment import (
    apply_intensity_scale_shift,
    apply_modality_dropout,
    intensity_scale_shift_draws,
    modality_dropout_draws,
)
from ..ops.flip_tta import flip_combos
from ..ops.losses import entropy_loss
from ..registry import register_tta_method
from ..utils.config import get_config
from .tent import TentAdapter, apply_restore, restore_draws

View = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def view_draws(shape: Sequence[int], n: int, generator: torch.Generator, *, scale: float, shift: float,
               noise: float) -> List[View]:
    """``n`` augmented views' random numbers: per view a per-sample intensity
    factor and offset (always applied) and, when ``noise > 0``, a standard
    normal tensor of the input's shape."""
    out = []
    for _ in range(n):
        factor, offset = intensity_scale_shift_draws(shape[0], generator, scale=scale, shift=shift, prob=1.0)
        z = torch.randn(tuple(shape), generator=generator, device=generator.device) if noise > 0.0 else None
        out.append((factor, offset, z))
    return out


def apply_view(x: torch.Tensor, view: View, noise: float) -> torch.Tensor:
    """The augmented view of ``x``: scale/shift, then ``noise * z``."""
    factor, offset, z = view
    xv = apply_intensity_scale_shift(x, factor, offset)
    return xv + noise * z if z is not None else xv


def view_combos(ndim: int, flip: bool) -> Tuple[Tuple[int, ...], ...]:
    """The non-empty spatial flip subsets the augmented views cycle through."""
    return flip_combos(tuple(range(1, ndim - 1)))[1:] if flip else ()


def flipped_probs(forward, xv: torch.Tensor, combo: Tuple[int, ...]) -> torch.Tensor:
    """``forward`` on the view mirrored along ``combo``, mirrored back; an
    output without the input's spatial axes (a classifier's ``[B, C]``) has
    nothing to mirror back."""
    if not combo:
        return forward(xv)
    p = forward(torch.flip(xv, dims=combo))
    return torch.flip(p, dims=combo) if p.dim() == xv.dim() else p


@register_tta_method("cotta")
class CottaAdapter(TentAdapter):
    """EMA-teacher pseudo-labeling adapter; the same surface as
    :class:`TentAdapter`."""

    method = "cotta"
    inline_caveats = False

    def __init__(self, tta_cfg, config=None, device_transform=None, *, device="cuda"):
        super().__init__(tta_cfg, config=config, device_transform=device_transform, device=device)

        self.ema = float(get_config(self.cfg, "ema", 0.999))
        self.n_views = int(get_config(self.cfg, "n_views", 2))
        self.aug_scale = float(get_config(self.cfg, "aug_scale", 0.1))
        self.aug_shift = float(get_config(self.cfg, "aug_shift", 0.1))
        self.aug_noise = float(get_config(self.cfg, "aug_noise", 0.05))
        self.aug_flip = bool(get_config(self.cfg, "aug_flip", True))
        self.serve = str(get_config(self.cfg, "serve", "teacher")).lower()
        if self.serve not in ("teacher", "student"):
            raise ValueError(f"[cotta] unknown serve mode: {self.serve}")
        if self.n_views < 1:
            raise ValueError("[cotta] n_views must be >= 1")
        if not (0.0 <= self.ema <= 1.0):
            raise ValueError(f"[cotta] ema must be in [0, 1], got {self.ema}")
        if self.window_enabled:
            raise ValueError(
                "[cotta] teacher pseudo-labeling needs whole-volume "
                "forwards; it is incompatible with tta.window"
            )
        if self.early_stop:
            raise ValueError(
                "[cotta] tta.early_stop is a Tent-objective brake; for "
                "cotta use the streaming watchdog (tta.stream.guard) — the "
                "entropy trace it needs is reported"
            )
        if self.loss_mode != "entropy":
            raise ValueError(
                "[cotta] tta.loss does not apply — the objective is teacher "
                "cross-entropy (itself a consistency loss)"
            )
        if self.rel_enabled:
            raise ValueError(
                "[cotta] tta.reliability gates the entropy objective; with "
                "teacher pseudo-labels use a smaller lr or tta.restore"
            )
        if self.fisher_enabled:
            raise ValueError(
                "[cotta] tta.fisher anchors the Tent objective; the EMA "
                "teacher + tta.restore are cotta's anti-forgetting mechanisms"
            )
        if self.n_views == 1 and not self.md_enabled:
            self.logger.warning(
                "[cotta] n_views=1 with no modality_dropout: student and "
                "teacher see the SAME clean input, and the CE objective has "
                "an exact fixed point at student == teacher (dCE/dlogit = "
                "sigmoid(l) - p = 0), so adaptation is ~inert. The "
                "augmented-view asymmetry IS the adaptation force — use "
                "n_views >= 2 (or enable tta.modality_dropout)"
            )
        self.logger.info(
            f"[cotta] EMA-teacher pseudo-labeling (ema={self.ema}, "
            f"views={self.n_views}, serve={self.serve}) — objective is "
            f"teacher CE; entropy_focus applies only to the monitor trace"
        )
        self._teacher: List[torch.Tensor] = []

    def _reset_carry(self) -> None:
        """The teacher back to the source values."""
        self._teacher = [s.clone() for s in self._source]

    def post_draws(self, shape) -> List[View]:
        """The teacher's augmented views (also of a post-update prediction)."""
        return view_draws(shape, self.n_views - 1, self.generator, scale=self.aug_scale, shift=self.aug_shift,
                          noise=self.aug_noise)

    def step_draws(self, shape, n_valid) -> dict:
        g = self.generator
        d = {"restore": None, "views": self.post_draws(shape), "drop": None}
        if self.restore_enabled:
            d["restore"] = restore_draws([p.shape for p in self._trainable], self.restore_prob, g)
        if self.md_enabled:
            d["drop"] = modality_dropout_draws(shape[0], shape[-1], g, prob=self.md_prob)
        return d

    @torch.no_grad()
    def _pseudo_labels(self, teacher: List[torch.Tensor], image: torch.Tensor, views: List[View]) -> torch.Tensor:
        """View-averaged teacher probabilities (view 0 clean); one view's
        activations live at a time."""
        values = dict(zip(self._names, teacher))

        def forward(x):
            return self._probs(functional_call(self._model, values, (x,)))

        p = forward(image)
        combos = view_combos(image.dim(), self.aug_flip)
        for i, v in enumerate(views):
            xv = apply_view(image, v, self.aug_noise)
            p = p + flipped_probs(forward, xv, combos[i % len(combos)] if combos else ())
        return p / float(self.n_views) if views else p

    def _adapt(self, state, image, n_valid, threshold, predict_mode, ent_floor=None):
        del ent_floor  # cotta has no early-stop brake
        image, w, denom = self._begin(state, image, n_valid)
        teacher = [s.clone() for s in self._source] if self.episodic else self._teacher
        inline = threshold is not None and predict_mode == "inline"
        post_teacher = threshold is not None and not inline and self.serve == "teacher"
        draws = self.batch_draws(tuple(image.shape), int(n_valid), post=post_teacher)
        opt = self._opt
        ents, logits, pseudo = [], None, None
        for i, d in enumerate(draws["steps"]):
            pseudo = self._pseudo_labels(teacher, image, d["views"])
            x = image
            if self.md_enabled and not (inline and i == self.steps - 1):
                x = apply_modality_dropout(x, d["drop"])
            logits = self._student(x)
            if self.sigmoid_mode:
                ce = -(pseudo * torch.nn.functional.logsigmoid(logits)
                       + (1.0 - pseudo) * torch.nn.functional.logsigmoid(-logits))
            else:
                ce = -(pseudo * torch.log_softmax(logits, dim=-1)).sum(dim=-1, keepdim=True)
            loss = (ce.mean(dim=tuple(range(1, ce.dim()))) * w).sum() / denom
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            with torch.no_grad():
                per_ent = entropy_loss(logits.detach(), sigmoid=self.sigmoid_mode, focus="uncertain",
                                       per_sample=True)
                ents.append((per_ent * w).sum() / denom)
                if d["restore"] is not None:
                    apply_restore(self._trainable, self._source, d["restore"])
                teacher = [self.ema * t + (1.0 - self.ema) * p for t, p in zip(teacher, self._trainable)]
        if not self.episodic:
            self._teacher = teacher
        self._last_ents = torch.stack(ents)
        if threshold is None:
            return None
        if inline:
            p = pseudo if self.serve == "teacher" else self._probs(logits.detach())
        elif self.serve == "teacher":
            p = self._pseudo_labels(teacher, image, draws["post"])
        else:
            with torch.no_grad():
                p = self._probs(self._student(image, update=False))
        return self._predict_probs(p, threshold)
