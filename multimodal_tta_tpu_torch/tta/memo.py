"""MEMO: marginal-entropy minimization over augmented views (method "memo";
the port of ``multimodal_tta_tpu/tta/memo.py``).

Zhang, Levine & Finn, "MEMO: Test Time Robustness via Adaptation and
Augmentation" (NeurIPS 2022 — public method): minimize the entropy of the
MARGINAL prediction ``p_bar = (1/V) sum_v p(y | aug_v(x))`` over V views,
with gradients through every view. The view family is CoTTA's
(``tta/cotta.py``): view 0 clean, each other view intensity scale/shift,
Gaussian noise and a mirror flip inverted in probability space. Per-voxel
entropies are reduced with Tent's ``entropy_focus``.

The gradient is linearized and accumulated view by view:

    dH(p_bar)/dtheta = sum_v < g_hat / V , d p_v / d theta >,
    g_hat = dH/dp at p_bar (analytic, elementwise, no gradient)

so each step runs (1) one no-grad pass over the views that forms ``p_bar``
and ``g_hat`` (the clip gate at ``_EPS`` zeroes ``g_hat`` where autograd
through the clamp would), then (2) one forward+backward of
``sum(p_v * g_hat / V)`` per view, accumulating into ``.grad``. Peak memory
holds one view's activations, whatever V is. The accumulated gradient is
autograd's of the marginal objective, to float rounding.

On a BatchNorm model the clean view is the statistics-recomputing pass (the
batch's statistics; the running statistics move once, in the marginal pass
of (1); the clean forward of (2) moves nothing) and the augmented views read
the statistics it wrote, as in the reference. A post-update prediction runs
the clean view the same way and moves them again, as the reference does.

Over ranks each rank takes its rows of the global batch's views; the
marginal stays per sample, the objective is each rank's sum over the
global valid count (its trace the ranks' total), the accumulated gradients
are summed over the ranks before the update, and a BatchNorm's statistics
pool over the ranks. Over a space axis the views are the rank's slabs (a
mirrored view's depth exchanged over the group), each sample's marginal
entropy is the slab's part over the group's denominators, and its
cotangent the whole objective's on the slab.
"""

from __future__ import annotations

import torch

from ..ops.augment import apply_modality_dropout
from ..ops.losses import reduce_dims
from ..parallel.space import space_sum
from ..registry import register_tta_method
from ..utils.config import get_config
from .cotta import apply_view, flipped_probs, view_combos
from .tent import TentAdapter, apply_restore, restored

_EPS = 1e-6


def marginal_entropy(p_marg: torch.Tensor, w: torch.Tensor, denom: torch.Tensor, *, sigmoid: bool,
                     focus: str, space=None):
    """The objective at the marginal and its analytic cotangent
    ``dLoss/dp`` (no gradient through either). ``space``: ``p_marg`` is this
    rank's depth slab; the objective is the slab's part, the cotangent the
    whole objective's on the slab."""
    b = p_marg.shape[0]
    pc = torch.clamp(p_marg, _EPS, 1.0 - _EPS)
    inside = ((p_marg > _EPS) & (p_marg < 1.0 - _EPS)).to(torch.float32)
    if sigmoid:
        h = -(pc * torch.log(pc) + (1.0 - pc) * torch.log1p(-pc))
        dhdp = (torch.log1p(-pc) - torch.log(pc)) * inside
    else:
        h = -(pc * torch.log(pc)).sum(dim=-1)
        dhdp = -(torch.log(pc) + 1.0) * inside
    ax = tuple(range(1, h.dim()))
    bshape = (b,) + (1,) * (h.dim() - 1)
    if focus == "uncertain":
        wsum = torch.clamp(space_sum(reduce_dims(h, ax), space), min=1e-12)
        per_sample = reduce_dims(h * h, ax) / wsum
        g_h = h * (w / denom / wsum).reshape(bshape)
    else:
        n = float(h[0].numel() * (1 if space is None else space.size))  # the whole sample's voxels
        per_sample = reduce_dims(h, ax, "mean") if space is None else reduce_dims(h, ax) / n
        g_h = ((w / denom) / n).reshape(bshape).expand(h.shape)
    g = g_h * dhdp if sigmoid else g_h[..., None] * dhdp
    return (per_sample * w).sum() / denom, g


@register_tta_method("memo")
class MemoAdapter(TentAdapter):
    """Marginal-entropy adapter; the same surface as :class:`TentAdapter`."""

    method = "memo"
    inline_caveats = False

    def __init__(self, tta_cfg, config=None, device_transform=None, *, device="cuda", mesh=None):
        super().__init__(tta_cfg, config=config, device_transform=device_transform, device=device, mesh=mesh)

        self.n_views = int(get_config(self.cfg, "n_views", 4))
        self.aug_scale = float(get_config(self.cfg, "aug_scale", 0.1))
        self.aug_shift = float(get_config(self.cfg, "aug_shift", 0.1))
        self.aug_noise = float(get_config(self.cfg, "aug_noise", 0.05))
        self.aug_flip = bool(get_config(self.cfg, "aug_flip", True))
        self.serve = str(get_config(self.cfg, "serve", "clean")).lower()
        if self.serve not in ("clean", "marginal"):
            raise ValueError(f"[memo] unknown serve mode: {self.serve}")
        if self.n_views < 1:
            raise ValueError("[memo] n_views must be >= 1")
        if self.n_views == 1:
            self.logger.warning(
                "[memo] n_views=1: the marginal is the clean prediction and "
                "the objective degenerates to plain Tent entropy — use "
                "n_views >= 2 (or method=tent, which is cheaper)"
            )
        if self.window_enabled:
            raise ValueError(
                "[memo] the marginal couples whole-volume views; it is "
                "incompatible with tta.window (use method=tent for windowed "
                "adaptation)"
            )
        if self.early_stop:
            raise ValueError(
                "[memo] tta.early_stop is a Tent-objective brake; for memo "
                "use the streaming watchdog (tta.stream.guard) — the entropy "
                "trace it needs is reported"
            )
        if self.rel_enabled:
            raise ValueError(
                "[memo] tta.reliability gates the per-view Tent objective; "
                "it does not compose with the marginal (use method=tent or "
                "method=eata)"
            )
        if self.fisher_enabled:
            raise ValueError(
                "[memo] tta.fisher anchors the Tent objective; with memo use "
                "tta.restore (composes) for anti-forgetting"
            )
        if self.loss_mode != "entropy":
            raise ValueError(
                "[memo] tta.loss does not apply — the marginal entropy is "
                "itself a confidence+consistency objective"
            )
        self.logger.info(
            f"[memo] marginal-entropy adaptation (views={self.n_views}, "
            f"serve={self.serve}, focus={self.entropy_focus}, "
            f"linearized per-view gradient accumulation)"
        )

    def _views_spec(self, shape) -> dict:
        """The augmented views of a marginal (also of a post-update one)."""
        return {"key": "views", "kind": "views", "n": self.n_views - 1, "shape": list(shape),
                "scale": self.aug_scale, "shift": self.aug_shift, "noise": self.aug_noise}

    def post_draw_spec(self, shape):
        return [self._views_spec(shape)]

    def step_draw_spec(self, shape):
        spec = []
        if self.restore_enabled:
            spec.append({"key": "restore", "kind": "bernoulli", "p": self.restore_prob,
                         "shapes": [list(p.shape) for p in self._trainable]})
        if self.md_enabled:
            spec.append({"key": "drop", "kind": "dropout", "b": shape[0], "m": shape[-1], "p": self.md_prob})
        return spec + [self._views_spec(shape)]

    def serving_post(self, mode: str) -> bool:
        return mode == "post" and self.serve == "marginal"

    def _view_probs(self, x: torch.Tensor, views, i: int, combos) -> torch.Tensor:
        xv = apply_view(x, views[i], self.aug_noise)
        return flipped_probs(lambda v: self._probs(self._run(v)), xv, combos[i % len(combos)] if combos else (),
                             self.space)

    @torch.no_grad()
    def _marginal(self, x: torch.Tensor, views):
        """Marginal probabilities over the views (view 0 clean) and the clean
        logits; the views run one after another."""
        logits0 = self._student(x)
        p = self._probs(logits0)
        combos = view_combos(x.dim(), self.aug_flip)
        for i in range(len(views)):
            p = p + self._view_probs(x, views, i, combos)
        return (p / float(self.n_views) if views else p), logits0

    def _surrogates(self, x: torch.Tensor, views, g_hat: torch.Tensor):
        """``<g_hat/V, p_v>`` for the clean view, then each augmented one, made
        one at a time: the caller differentiates each before the next."""
        gv = g_hat / float(self.n_views)
        combos = view_combos(x.dim(), self.aug_flip)
        yield (self._probs(self._student(x, update=False)) * gv).sum()
        for i in range(len(views)):
            yield (self._view_probs(x, views, i, combos) * gv).sum()

    def accumulate_grads(self, x: torch.Tensor, views, g_hat: torch.Tensor) -> None:
        """``.grad`` of the adapted params += d<g_hat/V, p_v>/dtheta, view by
        view (each a Tent-sized forward+backward)."""
        for s in self._surrogates(x, views, g_hat):
            s.backward()

    def _adapt(self, state, image, n_valid, threshold, predict_mode, ent_floor=None):
        del ent_floor  # no early-stop brake; the stream watchdog guards memo
        image, w, denom = self._begin(state, image, n_valid)
        inline = threshold is not None and predict_mode == "inline"
        post_marginal = threshold is not None and not inline and self.serve == "marginal"
        draws = self._local_draws(image, n_valid, post=post_marginal)
        opt = self._opt
        ents, p_marg, logits0 = [], None, None
        for i, d in enumerate(draws["steps"]):
            x = image
            if self.md_enabled and not (inline and i == self.steps - 1):
                x = apply_modality_dropout(x, d["drop"])
            p_marg, logits0 = self._marginal(x, d["views"])
            ent, g_hat = marginal_entropy(p_marg, w, denom, sigmoid=self.sigmoid_mode,
                                          focus=self.entropy_focus, space=self.space)
            opt.zero_grad(set_to_none=True)
            self.accumulate_grads(x, d["views"], g_hat)
            self._sum_grads()
            opt.step()
            if d["restore"] is not None:
                apply_restore(self._trainable, self._source, d["restore"])
            ents.append(self.mesh.total(ent))
        self._last_ents = torch.stack(ents)
        if threshold is None:
            return None
        if inline:
            p = p_marg if self.serve == "marginal" else self._probs(logits0)
        elif self.serve == "marginal":
            p, _ = self._marginal(image, draws["post"])
        else:
            with torch.no_grad():
                p = self._probs(self._student(image))
        return self._predict_probs(p, threshold)

    # ---- the pure serving step -------------------------------------------
    def _pure_step(self, state, image, draws, n_valid, ent_floor, thr, mode):
        """MEMO's step: the gradient of each view by ``torch.autograd.grad``,
        summed in the order the live step accumulates them."""
        del ent_floor  # no early-stop brake; the stream watchdog guards memo
        params, stats, opt, _ = self._split_state(state)
        image, w, denom = self._prepare(image, n_valid)
        ts = [params[n] for n in self._names]
        if self.episodic:
            opt = [t for _, t in self._opt_leaves(ts)]
        inline = mode == "inline"
        ents, p_marg, logits0 = [], None, None
        for i, d in enumerate(draws["steps"]):
            x = image
            if self.md_enabled and not (inline and i == self.steps - 1):
                x = apply_modality_dropout(x, d["drop"])
            leaves = [t.detach().requires_grad_() for t in ts]
            work = {k: v.clone() for k, v in stats.items()}
            with self._pure_values(params, leaves, work):
                p_marg, logits0 = self._marginal(x, d["views"])
                ent, g_hat = marginal_entropy(p_marg, w, denom, sigmoid=self.sigmoid_mode,
                                              focus=self.entropy_focus)
                grads = None
                with torch.enable_grad():
                    for s in self._surrogates(x, d["views"], g_hat):
                        g = torch.autograd.grad(s, leaves)
                        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            ts, opt = self._opt_update(ts, grads, opt)
            if d["restore"] is not None:
                ts = restored(ts, self._source, d["restore"])
            ents.append(ent)
            stats = work
        if inline:
            p = p_marg if self.serve == "marginal" else self._probs(logits0)
        else:
            work = {k: v.clone() for k, v in stats.items()}
            with self._pure_values(params, ts, work), torch.no_grad():
                if self.serve == "marginal":
                    p, _ = self._marginal(image, draws["post"])
                else:
                    p = self._probs(self._student(image))
            stats = work
        return self._join_state(params, ts, stats, opt, []), torch.stack(ents), self._predict_probs(p, thr)
