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

Over ranks each rank takes its rows of the global batch's views, the
student's gradients are summed over the ranks before each update, and the
restore masks come from the equally seeded generator: student and teacher
stay the same on every rank without a broadcast. Over a space axis the
views' noise is the rank's slab of the global draw, a mirrored view's
depth is exchanged over the group (``parallel/space.py:flip``), and each
sample's cross-entropy and entropy trace are the slab's parts over the
group's denominators.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..ops.augment import View, apply_intensity_scale_shift, apply_modality_dropout
from ..ops.flip_tta import flip_combos
from ..ops.losses import entropy_loss
from ..parallel import space as sp
from ..registry import register_tta_method
from ..utils.config import get_config
from .tent import TentAdapter, apply_restore, restored


def apply_view(x: torch.Tensor, view: View, noise: float) -> torch.Tensor:
    """The augmented view of ``x``: scale/shift, then ``noise * z``."""
    factor, offset, z = view
    xv = apply_intensity_scale_shift(x, factor, offset)
    return xv + noise * z if z is not None else xv


def view_combos(ndim: int, flip: bool) -> Tuple[Tuple[int, ...], ...]:
    """The non-empty spatial flip subsets the augmented views cycle through."""
    return flip_combos(tuple(range(1, ndim - 1)))[1:] if flip else ()


def flipped_probs(forward, xv: torch.Tensor, combo: Tuple[int, ...], space=None) -> torch.Tensor:
    """``forward`` on the view mirrored along ``combo``, mirrored back; an
    output without the input's spatial axes (a classifier's ``[B, C]``) has
    nothing to mirror back. ``space``: ``xv`` is this rank's depth slab."""
    if not combo:
        return forward(xv)
    p = forward(sp.flip(xv, combo, space))
    return sp.flip(p, combo, space) if p.dim() == xv.dim() else p


@register_tta_method("cotta")
class CottaAdapter(TentAdapter):
    """EMA-teacher pseudo-labeling adapter; the same surface as
    :class:`TentAdapter`."""

    method = "cotta"
    inline_caveats = False

    def __init__(self, tta_cfg, config=None, device_transform=None, *, device="cuda", mesh=None):
        super().__init__(tta_cfg, config=config, device_transform=device_transform, device=device, mesh=mesh)

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

    def _views_spec(self, shape) -> dict:
        """The teacher's augmented views (also of a post-update prediction)."""
        return {"key": "views", "kind": "views", "n": self.n_views - 1, "shape": list(shape),
                "scale": self.aug_scale, "shift": self.aug_shift, "noise": self.aug_noise}

    def post_draw_spec(self, shape):
        return [self._views_spec(shape)]

    def step_draw_spec(self, shape):
        spec = [self._views_spec(shape)]
        if self.restore_enabled:
            spec.append({"key": "restore", "kind": "bernoulli", "p": self.restore_prob,
                         "shapes": [list(p.shape) for p in self._trainable]})
        if self.md_enabled:
            spec.append({"key": "drop", "kind": "dropout", "b": shape[0], "m": shape[-1], "p": self.md_prob})
        return spec

    def serving_post(self, mode: str) -> bool:
        return mode == "post" and self.serve == "teacher"

    @torch.no_grad()
    def _pseudo_labels(self, teacher: List[torch.Tensor], image: torch.Tensor, views: List[View]) -> torch.Tensor:
        """View-averaged teacher probabilities (view 0 clean); one view's
        activations live at a time."""
        values = dict(zip(self._names, teacher))

        def forward(x):
            return self._probs(self._run(x, values))

        p = forward(image)
        combos = view_combos(image.dim(), self.aug_flip)
        for i, v in enumerate(views):
            xv = apply_view(image, v, self.aug_noise)
            p = p + flipped_probs(forward, xv, combos[i % len(combos)] if combos else (), self.space)
        return p / float(self.n_views) if views else p

    def _teacher_ce(self, logits, pseudo, w, denom) -> torch.Tensor:
        """The student's cross-entropy against the teacher's probabilities."""
        if self.sigmoid_mode:
            ce = -(pseudo * torch.nn.functional.logsigmoid(logits)
                   + (1.0 - pseudo) * torch.nn.functional.logsigmoid(-logits))
        else:
            ce = -(pseudo * torch.log_softmax(logits, dim=-1)).sum(dim=-1, keepdim=True)
        dims = tuple(range(1, ce.dim()))
        if self.space is None:
            per = ce.mean(dim=dims)
        else:  # the slab's part of each sample's mean
            per = ce.sum(dim=dims) / float(ce[0].numel() * self.space.size)
        return (per * w).sum() / denom

    def _monitor(self, logits, w, denom) -> torch.Tensor:
        """The entropy trace: the student's self-normalized entropy."""
        per_ent = entropy_loss(logits.detach(), sigmoid=self.sigmoid_mode, focus="uncertain", per_sample=True,
                               space=self.space)
        return (per_ent * w).sum() / denom

    def _ema_teacher(self, teacher, student) -> List[torch.Tensor]:
        return [self.ema * t + (1.0 - self.ema) * p.detach() for t, p in zip(teacher, student)]

    def _adapt(self, state, image, n_valid, threshold, predict_mode, ent_floor=None):
        del ent_floor  # cotta has no early-stop brake
        image, w, denom = self._begin(state, image, n_valid)
        teacher = [s.clone() for s in self._source] if self.episodic else self._teacher
        inline = threshold is not None and predict_mode == "inline"
        post_teacher = threshold is not None and not inline and self.serve == "teacher"
        draws = self._local_draws(image, n_valid, post=post_teacher)
        opt = self._opt
        ents, logits, pseudo = [], None, None
        for i, d in enumerate(draws["steps"]):
            pseudo = self._pseudo_labels(teacher, image, d["views"])
            x = image
            if self.md_enabled and not (inline and i == self.steps - 1):
                x = apply_modality_dropout(x, d["drop"])
            logits = self._student(x)
            loss = self._teacher_ce(logits, pseudo, w, denom)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            self._sum_grads()
            opt.step()
            with torch.no_grad():
                ents.append(self.mesh.total(self._monitor(logits, w, denom)))
                if d["restore"] is not None:
                    apply_restore(self._trainable, self._source, d["restore"])
                teacher = self._ema_teacher(teacher, self._trainable)
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

    # ---- the pure serving step -------------------------------------------
    def _carry_leaves(self):
        return [(f"teacher:{n}", s.clone()) for n, s in zip(self._names, self._source)]

    def _pure_step(self, state, image, draws, n_valid, ent_floor, thr, mode):
        """CoTTA's step; the teacher is the carry (the source values again
        in episodic mode)."""
        del ent_floor  # cotta has no early-stop brake
        params, stats, opt, teacher = self._split_state(state)
        image, w, denom = self._prepare(image, n_valid)
        ts = [params[n] for n in self._names]
        if self.episodic:
            opt, teacher = [t for _, t in self._opt_leaves(ts)], list(self._source)
        inline = mode == "inline"
        ents, logits, pseudo = [], None, None
        for i, d in enumerate(draws["steps"]):
            with self._pure_values(params, ts, stats):
                pseudo = self._pseudo_labels(teacher, image, d["views"])
            x = image
            if self.md_enabled and not (inline and i == self.steps - 1):
                x = apply_modality_dropout(x, d["drop"])
            leaves = [t.detach().requires_grad_() for t in ts]
            work = {k: v.clone() for k, v in stats.items()}
            with self._pure_values(params, leaves, work), torch.enable_grad():
                logits = self._student(x)
                grads = torch.autograd.grad(self._teacher_ce(logits, pseudo, w, denom), leaves)
            ts, opt = self._opt_update(ts, grads, opt)
            ents.append(self._monitor(logits, w, denom))
            if d["restore"] is not None:
                ts = restored(ts, self._source, d["restore"])
            teacher = self._ema_teacher(teacher, ts)
            stats = work
        if inline:
            p = pseudo if self.serve == "teacher" else self._probs(logits.detach())
        else:
            with self._pure_values(params, ts, stats), torch.no_grad():
                if self.serve == "teacher":
                    p = self._pseudo_labels(teacher, image, draws["post"])
                else:
                    p = self._probs(self._student(image, update=False))
        return self._join_state(params, ts, stats, opt, teacher), torch.stack(ents), self._predict_probs(p, thr)
