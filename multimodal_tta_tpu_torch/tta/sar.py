"""SAR: sharpness-aware test-time adaptation (method "sar"; the port of
``multimodal_tta_tpu/tta/sar.py``).

Niu et al., "Towards Stable Test-Time Adaptation in Dynamic Wild World"
(ICLR 2023 — public method), on the Tent adapter's machinery:

  1. **Reliable-sample filter** — samples whose SELF-NORMALIZED entropy
     exceeds ``margin_ratio * H_max`` are left out of the objective. The
     score is always the self-normalized entropy, whatever the objective's
     ``entropy_focus``.
  2. **Sharpness-aware step** — per inner step: the gradient g at θ, then
     the gradient at θ + ρ·g/(‖g‖ + 1e-12), which updates the unperturbed θ.
     In place: the perturbation is added under ``no_grad`` and θ is written
     back from a copy before ``opt.step()``.
  3. **Recovery reset** — an EMA ``em`` of the step's unfiltered monitor
     entropy (NaN until the first step); when it falls below
     ``reset_floor_ratio * H_max`` the adapted params and the optimizer
     snap back to source and ``em`` returns to NaN. ``em`` is carried
     across batches in continual mode; ``reset_optimizer`` clears it.

Each step runs two forwards and two backwards; the reset decision reads
``em`` on the host once a step (the pure serving step merges instead).
Over ranks each rank runs both passes on its rows: each pass's gradients
are summed over the ranks before use (the perturbation's scale
``rho / ||g||`` is the global batch's), and the monitor score is the global
one, so every rank's EMA and reset decision are the same. Over a space
axis each sample's objective and monitor score are the slab's parts over
the group's denominators, and the filter reads the whole sample's score
(the group's sum), alike on its ranks. On a BatchNorm model both forwards run on
the batch's statistics from the same running statistics, and the step keeps
those of the second (the reference's ``new_bs`` of the descent pass): the
running statistics move once a step. A recovery reset puts back the params,
not the statistics, as in the reference.
"""

from __future__ import annotations

import math

import torch

from ..ops.augment import apply_modality_dropout
from ..ops.losses import entropy_loss
from ..parallel.space import space_sum
from ..registry import register_tta_method
from ..utils.config import get_config
from .tent import TentAdapter


@register_tta_method("sar")
class SarAdapter(TentAdapter):
    """Sharpness-aware entropy minimization with recovery resets; the same
    surface as :class:`TentAdapter`."""

    method = "sar"
    inline_caveats = False

    def __init__(self, tta_cfg, config=None, device_transform=None, *, device="cuda", mesh=None):
        super().__init__(tta_cfg, config=config, device_transform=device_transform, device=device, mesh=mesh)

        self.rho = float(get_config(self.cfg, "rho", 0.05))
        self.margin_ratio = float(get_config(self.cfg, "margin_ratio", 0.4))
        self.reset_alpha = float(get_config(self.cfg, "reset_ema_alpha", 0.9))
        self.reset_floor_ratio = float(get_config(self.cfg, "reset_floor_ratio", 0.2))
        if self.rho <= 0.0:
            raise ValueError(f"[sar] rho must be > 0, got {self.rho}")
        if not (0.0 <= self.reset_alpha < 1.0):
            raise ValueError(f"[sar] reset_ema_alpha must be in [0, 1), got {self.reset_alpha}")
        if self.window_enabled:
            raise ValueError(
                "[sar] the SAM perturbation needs whole-volume objectives; "
                "incompatible with tta.window"
            )
        if self.early_stop:
            raise ValueError(
                "[sar] tta.early_stop duplicates SAR's own recovery scheme "
                "(reset_floor_ratio) — use that, or method=tent with early_stop"
            )
        if self.rel_enabled:
            raise ValueError(
                "[sar] the reliable-sample filter is built in (margin_ratio); "
                "tta.reliability does not compose"
            )
        if self.restore_enabled:
            raise ValueError(
                "[sar] recovery resets are SAR's anti-collapse mechanism; "
                "tta.restore does not compose (use method=tent with restore)"
            )
        if self.loss_mode != "entropy":
            raise ValueError("[sar] tta.loss must be 'entropy' (the SAR objective)")
        if self.fisher_enabled:
            raise ValueError(
                "[sar] tta.fisher anchors the Tent objective; SAR's recovery "
                "resets are its anti-forgetting mechanism (use method=eata)"
            )
        self.logger.info(
            f"[sar] sharpness-aware entropy minimization (rho={self.rho}, "
            f"margin={self.margin_ratio}*H_max, reset floor="
            f"{self.reset_floor_ratio}*H_max, ema alpha={self.reset_alpha})"
        )
        self._em = self._nan()

    def _nan(self) -> torch.Tensor:
        return torch.tensor(float("nan"), device=self.device)

    def _reset_carry(self) -> None:
        self._em = self._nan()

    def step_draw_spec(self, shape):
        if not self.md_enabled:
            return []
        return [{"key": "drop", "kind": "dropout", "b": shape[0], "m": shape[-1], "p": self.md_prob}]

    def _em_next(self, em: torch.Tensor, mon: torch.Tensor) -> torch.Tensor:
        """The entropy EMA after a step's monitor score (seeded by the first)."""
        return torch.where(torch.isnan(em), mon, self.reset_alpha * em + (1.0 - self.reset_alpha) * mon)

    def _h_max(self, logits: torch.Tensor) -> float:
        return math.log(2.0) if self.sigmoid_mode else math.log(float(logits.shape[-1]))

    def _loss(self, x: torch.Tensor, w: torch.Tensor, denom: torch.Tensor, update: bool):
        """Reliable-filtered objective, the unfiltered monitor score and the
        logits; the filter is recomputed at every evaluation point."""
        logits = self._student(x, update=update)
        per = entropy_loss(logits, sigmoid=self.sigmoid_mode, focus=self.entropy_focus, per_sample=True,
                           space=self.space)
        part = entropy_loss(logits.detach(), sigmoid=self.sigmoid_mode, focus="uncertain", per_sample=True,
                            space=self.space)
        score = space_sum(part, self.space)  # the whole sample's
        reliable = (score < self.margin_ratio * self._h_max(logits)).to(torch.float32)
        loss = (per * reliable * w).sum() / denom
        return loss, (part * w).sum() / denom, logits

    def _adapt(self, state, image, n_valid, threshold, predict_mode, ent_floor=None):
        del ent_floor  # SAR's recovery scheme replaces the early-stop brake
        image, w, denom = self._begin(state, image, n_valid)
        em = self._nan() if self.episodic else self._em
        inline = threshold is not None and predict_mode == "inline"
        draws = self._local_draws(image, n_valid)["steps"]
        params = self._trainable
        ents, logits = [], None
        for i, d in enumerate(draws):
            x = image
            if self.md_enabled and not (inline and i == self.steps - 1):
                x = apply_modality_dropout(x, d["drop"])
            loss, mon, logits = self._loss(x, w, denom, update=False)
            g = self.sum_grads(torch.autograd.grad(loss, params))
            scale = self.rho / (torch.sqrt(torch.stack([(t * t).sum() for t in g]).sum()) + 1e-12)
            with torch.no_grad():
                theta = [p.detach().clone() for p in params]
                for p, t in zip(params, g):
                    p.add_(scale * t)
            loss_sam, _, _ = self._loss(x, w, denom, update=True)
            g_sam = self.sum_grads(torch.autograd.grad(loss_sam, params))
            with torch.no_grad():
                for p, t, gs in zip(params, theta, g_sam):
                    p.copy_(t)
                    p.grad = gs
            self._opt.step()
            mon = self.mesh.total(mon.detach())
            em = self._em_next(em, mon)
            if bool(em < self.reset_floor_ratio * self._h_max(logits)):
                # collapsed into a degenerate minimum: back to source
                self._copy_source()
                self._opt = self._build_opt()
                em = self._nan()
            ents.append(mon)
        for p in params:
            p.grad = None
        if not self.episodic:
            self._em = em
        self._last_ents = torch.stack(ents)
        if threshold is None:
            return None
        if inline:
            return self._predict(logits.detach(), threshold)
        with torch.no_grad():
            return self._predict(self._run(image), threshold)

    # ---- the pure serving step -------------------------------------------
    def _carry_leaves(self):
        return [("em", self._nan())]

    def _pure_step(self, state, image, draws, n_valid, ent_floor, thr, mode):
        """SAR's step; the entropy EMA ``em`` is the carry. The recovery reset
        is a merge: params and optimizer state back to source, ``em`` to NaN,
        where the EMA falls below the floor (the live step reads it on the
        host instead)."""
        del ent_floor  # SAR's recovery scheme replaces the early-stop brake
        params, stats, opt, (em,) = self._split_state(state)
        image, w, denom = self._prepare(image, n_valid)
        ts = [params[n] for n in self._names]
        opt0 = [t for _, t in self._opt_leaves(ts)]
        if self.episodic:
            opt, em = opt0, self._nan()
        inline = mode == "inline"
        ents, logits = [], None
        for i, d in enumerate(draws["steps"]):
            x = image
            if self.md_enabled and not (inline and i == self.steps - 1):
                x = apply_modality_dropout(x, d["drop"])
            leaves = [t.detach().requires_grad_() for t in ts]
            with self._pure_values(params, leaves, stats), torch.enable_grad():
                loss, mon, logits = self._loss(x, w, denom, update=False)
                g = torch.autograd.grad(loss, leaves)
            scale = self.rho / (torch.sqrt(torch.stack([(t * t).sum() for t in g]).sum()) + 1e-12)
            perturbed = [(t + scale * gg).requires_grad_() for t, gg in zip(ts, g)]
            work = {k: v.clone() for k, v in stats.items()}
            with self._pure_values(params, perturbed, work), torch.enable_grad():
                loss_sam, _, _ = self._loss(x, w, denom, update=True)
                g_sam = torch.autograd.grad(loss_sam, perturbed)
            ts, opt = self._opt_update(ts, g_sam, opt)
            mon = mon.detach()
            em = self._em_next(em, mon)
            reset = em < self.reset_floor_ratio * self._h_max(logits)
            ts = [torch.where(reset, s, t) for t, s in zip(ts, self._source)]
            opt = [torch.where(reset, z, o) for o, z in zip(opt, opt0)]
            em = torch.where(reset, self._nan(), em)
            stats = work
            ents.append(mon)
        if inline:
            pred = self._predict(logits.detach(), thr)
        else:
            with self._pure_values(params, ts, stats), torch.no_grad():
                pred = self._predict(self._run(image), thr)
        return self._join_state(params, ts, stats, opt, [em]), torch.stack(ents), pred
