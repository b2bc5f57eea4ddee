"""Tent test-time adaptation (the port of ``multimodal_tta_tpu/tta/tent.py``).

Entropy minimization (Wang et al., "Tent", ICLR 2021) over sigmoid or
softmax outputs, with gradients reaching only the selected parameters
(by default the norm affines). Each batch: on-device intensity
normalization, K steps of forward + objective + backward + optimizer
update, and optionally the thresholded segmentation:

  * ``predict="post"``   — an extra forward with the updated params (strict
                           adapt-then-predict, what evaluation uses);
  * ``predict="inline"`` — the last adaptation step's own forward (the
                           official online Tent protocol, one forward less).

Episodic mode resets the adapted params to their source values and starts
a fresh optimizer for every batch; continual mode carries both.

The extras, each off by default and composable:
  * objectives: ``loss`` = entropy | pl (hard pseudo-labels), either with
    ``+consistency`` (an invariance term against an intensity-jittered view);
  * ``modality_dropout`` on every step but an inline prediction's last;
  * ``window``: the objective on random ROIs instead of whole volumes;
  * ``early_stop``: freeze the batch's adaptation once the step entropy falls
    below a floor (relative to the batch's first step, or the absolute
    ``ent_floor`` the stream controller passes);
  * ``restore``: after each update every adapted element snaps back to its
    source value with probability ``prob`` (the restore half of CoTTA);
  * ``reliability``: EATA's per-sample entropy gate and weighting;
  * ``fisher``: EATA's diagonal-Fisher anchor, applied as a proximal step
    after each update, estimated on the first ``fisher.batches`` batches.

Where the reference threads a functional ``TrainState``, the port adapts the
model in place: ``make_*`` take the model, freeze every parameter outside
the adapted set (``requires_grad=False``), keep a copy of the adapted
params' source values, and the returned functions take and return that same
model as the ``state``. ``restore()`` puts the source values back.

BatchNorm models (``models/layers.py:BatchNorm``): as in the reference,
the student forward of a step runs in training mode on the batch's
statistics and moves the running statistics once (the consistency view's
forward normalizes by its own batch but moves nothing); post-update
predictions, the Fisher estimate (at the source statistics) and the gated
forward read the running statistics; a frozen early-stop step leaves them
as they were. Episodic mode and ``restore()`` put the source statistics
back with the source params. A model without batch statistics runs every
forward as built (inference mode).

Randomness: the adapter owns one ``torch.Generator`` on its device, seeded
with ``task.seed + 777`` (the reference's ``PRNGKey``), kept across
``make_*`` calls and ``restore()``. Each batch takes its random numbers
from ``batch_draws`` (one dict per step: dropout mask, window offsets,
consistency factor and offset, restore masks) before it runs, and every
stochastic op is applied from those draws alone, so a test can hand both
packages the same numbers.

Over ranks (``mesh``, ``parallel/mesh.py``): each rank adapts on its rows
of the padded global batch, and the step equals one process's on the
global batch. The objective is each rank's masked sum over the GLOBAL
valid count (the windows' mean over the global window count; a batch
objective's sums meet before its division); the adapted tensors' gradients
are summed over the ranks in one ``all_reduce`` of a flat buffer, so every
rank takes the same update; a BatchNorm's statistics pool over the ranks
(``models/layers.py:pool_over_ranks``); the early-stop and gate entropies
are the global ones, so all ranks freeze and gate together. The draws are
made for the global batch from the equally seeded generator and each rank
takes its rows (``_local_draws``; its windows: ``windows_per_step`` must
divide by the data axis, and the windows are cut from the gathered global
batch). The methods built on this class (pl, eata, sar, cotta, memo) take
their draws, denominators and summed gradients the same way. The serving
artifact is one device's and refuses a mesh, as the reference's does. Over
a space axis each rank also holds a depth slab: the forwards
run split (``parallel/space.py``), each sample's objective is the slab's
part over the space group's denominator (so the world's sum holds it once),
and the predictions are the slab's. The draws are made for the global
depth too, and a view's noise is cut to the rank's slab. Tent's windows are
cut from the gathered global batch (rows and depth); a window whose depth
splits (``space.splits``) runs split, any other runs whole on every rank
of the space group and counts ``1 / space`` of it on each, so the world's
sum holds it once.
"""

from __future__ import annotations

import math
import re
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call

from .. import DeviceLike, resolve_device
from ..conf.node import ConfigNode
from ..models.convert import flax_path
from ..models.layers import (
    batch_statistics,
    has_batch_statistics,
    load_running_statistics,
    pool_over_ranks,
    reject_torch_batchnorm,
    running_statistics,
)
from ..ops.augment import (
    apply_intensity_scale_shift,
    apply_modality_dropout,
    group_draws,
    make_draws,
    window_draws,  # noqa: F401  (the windows' draws; tests import them from here)
)
from ..ops.intensity import make_intensity_normalizer
from ..ops.losses import entropy_loss, entropy_sums, pseudo_label_loss, pseudo_label_sums
from ..parallel import space as sp
from ..parallel.mesh import Mesh
from ..parallel.space import space_sum
from ..parallel.tensor import shard_axes
from ..registry import register_tta_method
from ..utils.config import get_config
from ..utils.logger import get_logger

_AFFINE = {"scale", "bias"}


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


def reliability_weights(logits: torch.Tensor, *, sigmoid: bool, margin_ratio: float, space=None) -> torch.Tensor:
    """EATA-style per-sample reliability weights, [B] in [0, e^margin]: a
    sample whose SELF-NORMALIZED entropy exceeds ``margin_ratio * H_max``
    gets 0, the rest ``exp(margin - e)``. H_max = ln 2 per Bernoulli channel
    (sigmoid) or ln C (softmax). No gradient flows through the weights.
    Over a space axis the sample's entropy is the space group's whole."""
    e = entropy_loss(logits.detach(), sigmoid=sigmoid, focus="uncertain", per_sample=True, space=space)
    e = space_sum(e, space)
    h_max = math.log(2.0) if sigmoid else math.log(float(logits.shape[-1]))
    margin = margin_ratio * h_max
    return torch.where(e < margin, torch.exp(margin - e), torch.zeros_like(e))


def apply_crop_windows(x: torch.Tensor, corners: torch.Tensor, roi: Sequence[int]) -> torch.Tensor:
    """``[W, *roi, C]`` windows of ``x`` [B, D, H, W, C] at ``corners``
    (``window_draws``), gathered by index tensors: no host read, so a traced
    step holds it."""
    c = corners.to(x.device)
    s, starts = c[:, 0], c[:, 1:]
    idx = [starts[:, k, None] + torch.arange(int(r), device=x.device) for k, r in enumerate(roi)]
    return x[s[:, None, None, None], idx[0][:, :, None, None], idx[1][:, None, :, None], idx[2][:, None, None, :]]


def restored(params: Sequence[torch.Tensor], sources: Sequence[torch.Tensor],
             masks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``params`` with the source value wherever its mask is set."""
    return [torch.where(m, s, p) for p, s, m in zip(params, sources, masks)]


@torch.no_grad()
def apply_restore(params: Sequence[torch.Tensor], sources: Sequence[torch.Tensor],
                  masks: Sequence[torch.Tensor]) -> None:
    """``restored``, written into ``params`` (in place)."""
    for p, r in zip(params, restored(params, sources, masks)):
        p.copy_(r)


@register_tta_method("tent")
class TentAdapter:
    """Builds ``adapt_fn(state, image, n_valid)``,
    ``adapt_predict_fn(state, image, n_valid)`` and
    ``forward_predict_fn(state, image, n_valid)`` closures over one model."""

    method = "tent"
    # Tent's own step loop carries the inline caveats of _check_predict_mode;
    # a method with its own loop (sar, cotta, memo) sets this False
    inline_caveats = True

    def __init__(self, tta_cfg, config=None, device_transform=None, *, device: DeviceLike = "cuda", mesh=None):
        self.cfg = tta_cfg or ConfigNode()
        self.config = config or ConfigNode()
        self.device = resolve_device(device)
        self.logger = get_logger()
        # the data axis over ranks (one process: a mesh of one rank)
        self.mesh = mesh if mesh is not None else Mesh(self.device)

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

        md = get_config(self.cfg, "modality_dropout", ConfigNode())
        self.md_enabled = bool(get_config(md, "enabled", False))
        self.md_prob = float(get_config(md, "prob", 0.25))

        wnd = get_config(self.cfg, "window", ConfigNode())
        self.window_enabled = bool(get_config(wnd, "enabled", False))
        self.window_roi = tuple(int(x) for x in get_config(wnd, "roi_size", [32, 96, 96]))
        self.windows_per_step = int(get_config(wnd, "windows_per_step", 4))
        self.space = sp.axis_of(self.mesh)
        if self.window_enabled and self.windows_per_step % self.mesh.data:
            raise ValueError(
                f"[tent] tta.window.windows_per_step={self.windows_per_step} must divide by the data "
                f"axis ({self.mesh.data}): each rank adapts on its share of the windows")

        self.predict_mode = str(get_config(self.cfg, "predict", "post")).lower()
        if self.predict_mode not in ("post", "inline"):
            raise ValueError(f"[tent] unknown predict mode: {self.predict_mode}")

        es = get_config(self.cfg, "early_stop", ConfigNode())
        self.early_stop = bool(get_config(es, "enabled", False))
        self.early_stop_ratio = float(get_config(es, "entropy_floor_ratio", 0.3))

        rst = get_config(self.cfg, "restore", ConfigNode())
        self.restore_enabled = bool(get_config(rst, "enabled", False))
        self.restore_prob = float(get_config(rst, "prob", 0.01))
        if self.restore_enabled:
            self.logger.info(
                f"[tent] stochastic restore to source enabled "
                f"(prob={self.restore_prob} per element per step)"
            )

        rel = get_config(self.cfg, "reliability", ConfigNode())
        self.rel_enabled = bool(get_config(rel, "enabled", False))
        self.rel_margin_ratio = float(get_config(rel, "margin_ratio", 0.4))
        if self.rel_enabled:
            self.logger.info(
                f"[tent] reliability gating enabled "
                f"(margin = {self.rel_margin_ratio} * H_max, EATA-style)"
            )

        fsh = get_config(self.cfg, "fisher", ConfigNode())
        self.fisher_enabled = bool(get_config(fsh, "enabled", False))
        self.fisher_lambda = float(get_config(fsh, "lambda", 100.0))
        self.fisher_batches = int(get_config(fsh, "batches", 4))
        if self.fisher_enabled:
            if self.fisher_batches < 1:
                raise ValueError("[tent] tta.fisher.batches must be >= 1")
            self.logger.info(
                f"[tent] Fisher anti-forgetting enabled (lambda="
                f"{self.fisher_lambda}, estimated on first "
                f"{self.fisher_batches} batches, EATA-style)"
            )

        self.entropy_focus = str(get_config(self.cfg, "entropy_focus", "all")).lower()
        if self.entropy_focus not in ("all", "uncertain"):
            raise ValueError(f"[tent] unknown entropy_focus: {self.entropy_focus}")

        self.loss_mode = str(get_config(self.cfg, "loss", "entropy")).lower()
        if self.loss_mode not in ("entropy", "entropy+consistency", "pl", "pl+consistency"):
            raise ValueError(f"[tent] unknown loss mode: {self.loss_mode}")
        plc = get_config(self.cfg, "pl", ConfigNode())
        self.pl_conf_threshold = float(get_config(plc, "conf_threshold", 0.9))
        cons = get_config(self.cfg, "consistency", ConfigNode())
        self.cons_weight = float(get_config(cons, "weight", 1.0))
        self.cons_scale = float(get_config(cons, "scale", 0.1))
        self.cons_shift = float(get_config(cons, "shift", 0.1))

        if not bool(get_config(self.cfg, "sync_over_mesh", True)):
            raise ValueError(
                f"[{get_config(self.cfg, 'method', 'tent')}] sync_over_mesh="
                f"false is not supported: the adapt step always pools over "
                f"the batch"
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
        self._names: List[str] = []
        self._trainable: List[nn.Parameter] = []
        self._source: List[torch.Tensor] = []
        self._bn = False
        self._source_stats: Dict[str, torch.Tensor] = {}
        self._opt: Optional[torch.optim.Optimizer] = None
        self._last_ents: Optional[torch.Tensor] = None
        self._fisher_sum: Optional[List[torch.Tensor]] = None
        self._fisher_n = 0
        self._fisher_cached: Optional[List[torch.Tensor]] = None
        # inside a pure serving step: the values of every param and running
        # statistic that the model's forwards read (``_run``)
        self._values: Optional[Dict[str, torch.Tensor]] = None
        seed = int(get_config(self.config, "task.seed", 0)) + 777
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @property
    def last_entropy(self) -> Optional[float]:
        """Final-step entropy of the most recent adaptation (read from the
        device on access, not per batch)."""
        if self._last_ents is None:
            return None
        return float(self._last_ents[-1])

    def reset_optimizer(self) -> None:
        """Drop the accumulated optimizer state (momentum) and whatever else
        the method carries from batch to batch — the state half of a
        streaming re-anchor; ``restore()`` is the param half."""
        if self._model is not None:
            self._opt = self._build_opt()
        self._reset_carry()

    def _reset_carry(self) -> None:
        """Per-method carried state back to its source value (Tent: none)."""

    # ------------------------------------------------------------------
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
        if self.loss_mode.split("+")[0] == "pl":
            obj_desc = f"hard pseudo-label CE (conf_threshold={self.pl_conf_threshold})"
        elif self.entropy_focus == "uncertain":
            obj_desc = "self-normalized entropy (focus=uncertain)"
        else:
            obj_desc = "plain Tent entropy (focus=all)"
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
        """Select and unfreeze the adapted params, freeze the rest, keep the
        adapted params' source values, and start the carried state afresh."""
        reject_torch_batchnorm(model)
        for p in model.parameters():
            if p.device != self.device:
                raise ValueError(f"[{self.method}] model is on {p.device}, adapter on {self.device}")
        mask = self._param_mask(model)
        pool_over_ranks(model, self.mesh)
        self._model = model
        self._names, self._trainable = [], []
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name])
            if mask[name]:
                self._names.append(name)
                self._trainable.append(p)
        self._source = [p.detach().clone() for p in self._trainable]
        self._shards = shard_axes(model, self._names)  # Mesh.sum_flat's: the axis each is cut over
        self._bn = has_batch_statistics(model)
        self._source_stats = running_statistics(model)
        self._opt = self._build_opt()
        self._reset_carry()
        self._last_ents = None

    def _predict(self, logits: torch.Tensor, threshold: float) -> torch.Tensor:
        """Sigmoid mode thresholds per channel; softmax mode takes the
        channel argmax."""
        if self.sigmoid_mode:
            return (torch.sigmoid(logits) >= threshold).to(torch.uint8)
        return torch.argmax(logits, dim=-1, keepdim=True).to(torch.uint8)

    def _probs(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(logits) if self.sigmoid_mode else torch.softmax(logits, dim=-1)

    def _predict_probs(self, p: torch.Tensor, threshold: float) -> torch.Tensor:
        if self.sigmoid_mode:
            return (p >= threshold).to(torch.uint8)
        return torch.argmax(p, dim=-1, keepdim=True).to(torch.uint8)

    @torch.no_grad()
    def _copy_source(self) -> None:
        """The adapted params back to their source values (the running
        statistics stay: SAR's recovery resets the params only)."""
        for p, s in zip(self._trainable, self._source):
            p.copy_(s)

    def _run(self, x: torch.Tensor, values: Optional[Dict[str, torch.Tensor]] = None,
             split: bool = True) -> torch.Tensor:
        """The bound model on ``x``, with ``values`` (name -> tensor) in
        place of its own params where given (``functional_call``). Inside a
        pure serving step every param and running statistic comes from the
        step's values (``_pure_values``). ``split=False``: ``x`` is whole on
        every rank of the space group (a window whose depth does not split)."""
        if self._values is not None:
            values = dict(self._values, **(values or {}))
        with sp.sharded(self.mesh) if split else sp.ambient(None):
            return self._model(x) if values is None else functional_call(self._model, values, (x,))

    def _student(self, x: torch.Tensor, update: bool = True, split: bool = True) -> torch.Tensor:
        """The reference's student ``forward(trainable, bs, x)``: a BatchNorm
        model runs in training mode on ``x``'s statistics and, with
        ``update``, keeps the forward's new running statistics (once); a
        model without them runs as built."""
        if not self._bn:
            return self._run(x, split=split)
        with batch_statistics(self._model, update=update):
            return self._run(x, split=split)

    def _prepare(self, image, n_valid):
        """The normalized f32 image on the device, the valid-sample weights
        of its rows and the global valid count (at least 1): over ranks,
        ``image`` is this rank's rows and ``n_valid`` counts the global
        batch."""
        image = torch.as_tensor(image).to(self.device, torch.float32)
        if self._norm_fn is not None:
            image = self._norm_fn(image, space=self.space)
        n = image.shape[0] * self.mesh.data
        w = (torch.arange(n, device=image.device) < n_valid).to(torch.float32)
        return image, w[self.mesh.rows(n)], torch.clamp(w.sum(), min=1.0)

    def _global_shape(self, image: torch.Tensor) -> Tuple[int, ...]:
        """The shape of the global batch that ``image`` is this rank's rows
        (and, over a space axis, depth slab) of."""
        depth = image.shape[1] * sp.space_size(self.space)
        return (image.shape[0] * self.mesh.data, depth) + tuple(image.shape[2:])

    def _rank_views(self, views, n: int):
        """This rank's share of augmented views drawn for a global batch of
        ``n``: its rows of each view's factor and offset, its rows and depth
        slab of the noise."""
        rows = self.mesh.rows(n)
        return [(f[rows], o[rows], None if z is None else self.mesh.local(z)) for f, o, z in views]

    def _rank_draws(self, d: dict, n: int) -> dict:
        """This rank's share of one step's draws for a global batch of
        ``n``: its rows of the per-sample draws and views, its windows (and
        their consistency draws); the restore masks are the params' and
        stay."""
        rows = self.mesh.rows(n)
        d = dict(d)
        if d.get("drop") is not None:
            d["drop"] = d["drop"][rows]
        if d.get("views") is not None:
            d["views"] = self._rank_views(d["views"], n)
        if d.get("windows") is not None:
            rows = self.mesh.rows(self.windows_per_step)
            d["windows"] = d["windows"][rows]
        if d.get("cons") is not None:
            d["cons"] = tuple(t[rows] for t in d["cons"])
        return d

    def _local_draws(self, image: torch.Tensor, n_valid, post: bool = False) -> dict:
        """``batch_draws`` for the global batch that ``image`` is this rank's
        rows of, cut to this rank's share: over ranks every rank draws what
        one process draws, from its equally seeded generator."""
        shape = self._global_shape(image)
        draws = self.batch_draws(shape, int(n_valid), post=post)
        return {"steps": [self._rank_draws(d, shape[0]) for d in draws["steps"]],
                "post": None if draws["post"] is None else self._rank_views(draws["post"], shape[0])}

    def _sum_grads(self) -> None:
        """The adapted tensors' gradients summed over the ranks in one
        ``all_reduce`` of a flat buffer (``sum_grads``). Every rank has
        gradients for the same tensors (one graph), and a tensor without one
        stays without, as in one process."""
        held = [i for i, p in enumerate(self._trainable) if p.grad is not None]
        grads = self.sum_grads([self._trainable[i].grad for i in held], held)
        for i, g in zip(held, grads):
            self._trainable[i].grad = g

    def sum_grads(self, grads, held=None) -> List[torch.Tensor]:
        """Gradients of the adapted tensors (of those at ``held``, all by
        default) summed over the ranks, and averaged over a model or expert
        group where the tensor is whole (``Mesh.sum_flat``): every rank of
        the group then steps the same bits."""
        held = range(len(self._trainable)) if held is None else held
        return self.mesh.sum_flat(list(grads), [self._shards[i] for i in held])

    def _begin(self, state: nn.Module, image: torch.Tensor, n_valid):
        """Common head of a batch: the state check, the episodic reset, and
        ``_prepare``."""
        if state is not self._model:
            raise ValueError(f"[{self.method}] the state must be the model this function was built with")
        if self.episodic:
            self._copy_source()
            load_running_statistics(self._model, self._source_stats)
            self._opt = self._build_opt()
        return self._prepare(image, n_valid)

    # ------------------------------------------------------------------
    def step_draw_spec(self, shape: Tuple[int, ...]) -> List[dict]:
        """What one adaptation step draws, in generator order
        (``ops/augment.py``: restore masks, dropout, windows, consistency)."""
        spec = []
        if self.restore_enabled:
            spec.append({"key": "restore", "kind": "bernoulli", "p": self.restore_prob,
                         "shapes": [list(p.shape) for p in self._trainable]})
        if self.md_enabled:
            spec.append({"key": "drop", "kind": "dropout", "b": shape[0], "m": shape[-1], "p": self.md_prob})
        if self.window_enabled:
            spec.append({"key": "windows", "kind": "windows", "n": self.windows_per_step,
                         "spatial": list(shape[1:4]), "roi": list(self.window_roi)})
        if self.loss_mode.endswith("+consistency"):
            nb = self.windows_per_step if self.window_enabled else shape[0]
            spec.append({"key": "cons", "kind": "scale_shift", "n": nb, "scale": self.cons_scale,
                         "shift": self.cons_shift})
        return spec

    def post_draw_spec(self, shape: Tuple[int, ...]) -> Optional[List[dict]]:
        """What a post-update ensemble prediction draws (Tent: nothing)."""
        return None

    def batch_draw_spec(self, shape: Tuple[int, ...], post: bool = False) -> dict:
        """``{"steps": [one spec per step], "post": post spec or None}``."""
        return {"steps": [self.step_draw_spec(shape) for _ in range(self.steps)],
                "post": self.post_draw_spec(shape) if post else None}

    def step_draws(self, shape: Tuple[int, ...], n_valid: int) -> dict:
        """One adaptation step's random numbers, from ``self.generator``."""
        spec = {"steps": [self.step_draw_spec(shape)], "post": None}
        return group_draws(spec, make_draws(spec, self.generator, n_valid))["steps"][0]

    def post_draws(self, shape: Tuple[int, ...]):
        """A post-update ensemble prediction's random numbers (Tent: None)."""
        post = self.post_draw_spec(shape)
        if post is None:
            return None
        spec = {"steps": [], "post": post}
        return group_draws(spec, make_draws(spec, self.generator, shape[0]))["post"]

    def batch_draws(self, shape: Tuple[int, ...], n_valid: int, post: bool = False) -> dict:
        """A batch's draws: ``{"steps": [one dict per step], "post":
        post_draws or None}``, taken before the batch runs."""
        spec = self.batch_draw_spec(shape, post)
        return group_draws(spec, make_draws(spec, self.generator, n_valid))

    def _per_sample_objective(self, logits: torch.Tensor, whole: bool = False) -> torch.Tensor:
        # over a space axis: this slab's part of each sample's value (``whole``:
        # the logits are the whole volumes')
        space = None if whole else self.space
        if self.loss_mode.startswith("pl"):
            return pseudo_label_loss(logits, sigmoid=self.sigmoid_mode,
                                     conf_threshold=self.pl_conf_threshold, per_sample=True, space=space)
        return entropy_loss(logits, sigmoid=self.sigmoid_mode, focus=self.entropy_focus, per_sample=True,
                            space=space)

    def _batch_objective(self, logits: torch.Tensor) -> torch.Tensor:
        # over ranks the sums meet before the division (the denominators
        # carry no gradient; every rank holds as many elements). Over a space
        # axis a whole window's sums are alike on the group's ranks: its
        # denominators then take the group's size as a factor, so each rank
        # holds 1 / space of the value, as a split window's slab holds its part
        if self.loss_mode.startswith("pl"):
            num, den = pseudo_label_sums(logits, sigmoid=self.sigmoid_mode, conf_threshold=self.pl_conf_threshold)
            return num / torch.clamp(self.mesh.total(den), min=1.0)
        num, den = entropy_sums(logits, sigmoid=self.sigmoid_mode, focus=self.entropy_focus)
        if self.entropy_focus == "uncertain":
            return num / torch.clamp(self.mesh.total(den), min=1e-12)
        return num / (den * self.mesh.data * sp.space_size(self.space))

    def _objective(self, x: torch.Tensor, d: dict, w: torch.Tensor, denom: torch.Tensor):
        """The step's loss and the logits of its (first) forward."""
        if self.window_enabled:
            x = self.mesh.gather(x)  # a rank's windows may lie in other ranks' rows and slabs
            x = apply_crop_windows(x, d["windows"], self.window_roi)
            # over a space axis a window runs split where its depth splits,
            # else whole on every rank of the group (1 / space of it on each)
            whole = self.space is not None and not sp.splits(x.shape[1], self.space.size)
            if self.space is not None and not whole:
                x = sp.slice_depth(x, self.space, dim=1)
            logits = self._student(x, split=not whole)
            if self.rel_enabled:
                ww = reliability_weights(logits, sigmoid=self.sigmoid_mode, margin_ratio=self.rel_margin_ratio,
                                         space=None if whole else self.space)
                share = self.space.size if whole else 1
                loss = (self._per_sample_objective(logits, whole) * ww).sum() / float(self.windows_per_step * share)
            else:
                loss = self._batch_objective(logits)
            if d["cons"] is not None:
                p2 = self._probs(self._student(apply_intensity_scale_shift(x, *d["cons"]), update=False,
                                               split=not whole))
                sq = (self._probs(logits) - p2) ** 2
                loss = loss + self.cons_weight * sq.sum() / float(sq.numel() * self.mesh.data
                                                                  * sp.space_size(self.space))
            return loss, logits
        logits = self._student(x)
        sw = w
        if self.rel_enabled:
            sw = w * reliability_weights(logits, sigmoid=self.sigmoid_mode, margin_ratio=self.rel_margin_ratio,
                                         space=self.space)
        loss = (self._per_sample_objective(logits) * sw).sum() / denom
        if d["cons"] is not None:
            p2 = self._probs(self._student(apply_intensity_scale_shift(x, *d["cons"]), update=False))
            sq = (self._probs(logits) - p2) ** 2
            per_cons = sq.sum(dim=tuple(range(1, logits.dim()))) / float(sq[0].numel() * sp.space_size(self.space))
            loss = loss + self.cons_weight * (per_cons * w).sum() / denom
        return loss, logits

    @torch.no_grad()
    def _after_update(self, d: dict, fisher: Optional[List[torch.Tensor]]) -> None:
        """The Fisher proximal step, then the stochastic restore."""
        if fisher is not None:
            c = self.lr * self.fisher_lambda
            for p, s, f in zip(self._trainable, self._source, fisher):
                p.copy_(s + (p - s) / (1.0 + c * f))
        if d["restore"] is not None:
            apply_restore(self._trainable, self._source, d["restore"])

    def _adapt(self, state: nn.Module, image: torch.Tensor, n_valid,
               threshold: Optional[float], predict_mode: str,
               ent_floor: Optional[float] = None) -> Optional[torch.Tensor]:
        image, w, denom = self._begin(state, image, n_valid)
        fisher = None
        if self.fisher_enabled:
            self._maybe_accumulate_fisher(image, w, denom)
            fisher = self._fisher_arg()
        inline = threshold is not None and predict_mode == "inline"
        draws = self._local_draws(image, n_valid)["steps"]
        opt = self._opt
        ents, logits = [], None
        active, e0 = True, float("nan")
        for i, d in enumerate(draws):
            x = image
            if self.md_enabled and not (inline and i == self.steps - 1):
                x = apply_modality_dropout(x, d["drop"])
            held = running_statistics(self._model) if self.early_stop else None
            with torch.set_grad_enabled(active):
                loss, logits = self._objective(x, d, w, denom)
            ent_t = self.mesh.total(loss.detach())
            ents.append(ent_t)
            if self.early_stop:
                # freeze once the step entropy falls below the floor: the
                # reference discards the step's update (params and running
                # statistics) and keeps the state for the rest of the batch
                # (its trace then reports the frozen params' entropy, as the
                # forwards here do)
                ent = float(ent_t)
                if e0 != e0:
                    e0 = ent
                floor = self.early_stop_ratio * e0 if ent_floor is None or ent_floor != ent_floor else ent_floor
                active = active and ent >= floor
                if not active:
                    load_running_statistics(self._model, held)
                    continue
            opt.zero_grad(set_to_none=True)
            loss.backward()
            self._sum_grads()
            opt.step()
            self._after_update(d, fisher)
        self._last_ents = torch.stack(ents)
        if threshold is None:
            return None
        if inline:
            return self._predict(logits.detach(), threshold)
        with torch.no_grad():
            return self._predict(self._run(image), threshold)

    # ------------------------------------------------------------------
    @contextmanager
    def _at_source(self):
        """The adapted params and the running statistics at their source
        values for the block, then back to what they were."""
        with torch.no_grad():
            held = [p.detach().clone() for p in self._trainable]
            held_stats = running_statistics(self._model)
            self._copy_source()
            load_running_statistics(self._model, self._source_stats)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, h in zip(self._trainable, held):
                    p.copy_(h)
                load_running_statistics(self._model, held_stats)

    def _maybe_accumulate_fisher(self, image: torch.Tensor, w: torch.Tensor, denom: torch.Tensor) -> None:
        """Squared entropy gradients of the SOURCE model on this batch, summed
        over the first ``fisher.batches`` batches (kept across ``make_*``)."""
        if self._fisher_n >= self.fisher_batches:
            return
        with self._at_source():
            logits = self._run(image)
            per = entropy_loss(logits, sigmoid=self.sigmoid_mode, focus=self.entropy_focus, per_sample=True,
                               space=self.space)
            grads = self.sum_grads(torch.autograd.grad((per * w).sum() / denom, self._trainable))
        sq = [g * g for g in grads]
        self._fisher_sum = sq if self._fisher_sum is None else [a + b for a, b in zip(self._fisher_sum, sq)]
        self._fisher_n += 1

    def _fisher_arg(self) -> List[torch.Tensor]:
        """Batch-mean Fisher normalized to mean 1 over all elements; cached
        once the estimation window is full."""
        if self._fisher_cached is not None:
            return self._fisher_cached
        f = [s / float(max(self._fisher_n, 1)) for s in self._fisher_sum]
        mean = torch.stack([t.sum() for t in f]).sum() / float(sum(t.numel() for t in f))
        out = [t / torch.clamp(mean, min=1e-30) for t in f]
        if self._fisher_n >= self.fisher_batches:
            self._fisher_cached = out
        return out

    # ------------------------------------------------------------------
    def restore(self) -> None:
        """Write the source values back into the bound model's adapted
        params and running statistics, drop the gradients, start a fresh
        optimizer and reset the method's carried state — the model is again
        what it was when it was bound. The reference's adapt functions are pure and leave the
        caller's state alone; the port adapts in place, so whoever borrowed a
        model (``TTAEngine.evaluate``) calls this when done. The
        ``requires_grad`` flags stay as bound; the generator and the Fisher
        estimate carry on, as the reference's do."""
        if self._model is None:
            return
        self._copy_source()
        load_running_statistics(self._model, self._source_stats)
        for p in self._trainable:
            p.grad = None
        self.reset_optimizer()

    def make_adapt_fn(self, source_model: nn.Module) -> Callable:
        """``adapt_fn(state, image, n_valid, ent_floor=None) -> state``:
        adapts the model in place (from its source values in episodic mode)
        and returns it."""
        self._bind(source_model)

        def adapt_fn(state, image, n_valid, ent_floor=None):
            self._adapt(state, image, n_valid, None, "post", ent_floor)
            return state

        return adapt_fn

    def _check_predict_mode(self, mode: str) -> None:
        """The mode's validity, and Tent's inline caveats where the class
        keeps them (``inline_caveats``)."""
        if mode not in ("post", "inline"):
            raise ValueError(f"[{self.method}] unknown predict mode: {mode}")
        if mode != "inline" or not self.inline_caveats:
            return
        if self.window_enabled:
            raise ValueError(
                "[tent] predict=inline needs the adaptation forward to be "
                "whole-volume; it is incompatible with tta.window"
            )
        if self.episodic and self.steps == 1:
            self.logger.warning(
                "[tent] predict=inline with episodic=true, steps=1: "
                "predictions come from the pre-update forward and the "
                "state resets per batch, so adaptation cannot affect any "
                "prediction — use episodic=false (continual) or steps>1"
            )
        if self.md_enabled and self.steps == 1:
            self.logger.warning(
                "[tent] predict=inline runs the final (here: only) step "
                "on the CLEAN batch so served predictions are never "
                "dropout-corrupted — with steps=1 modality_dropout "
                "therefore never applies; use steps>1"
            )

    def make_adapt_predict_fn(self, source_model: nn.Module, threshold: float,
                              predict_mode: Optional[str] = None) -> Callable:
        """``adapt_predict_fn(state, image, n_valid, ent_floor=None) ->
        (state, pred uint8)``: adaptation and segmentation in one call (the
        serving step). ``predict_mode`` defaults to ``tta.predict``."""
        mode = (predict_mode or self.predict_mode).lower()
        self._check_predict_mode(mode)
        self._bind(source_model)
        thr = float(threshold)

        def adapt_predict_fn(state, image, n_valid, ent_floor=None):
            pred = self._adapt(state, image, n_valid, thr, mode, ent_floor)
            return state, pred

        return adapt_predict_fn

    def make_forward_predict_fn(self, source_model: nn.Module, threshold: float) -> Callable:
        """``forward_predict_fn(state, image, n_valid) -> (pred uint8,
        entropy_objective, entropy_gate)``: the gated-serving fast path — one
        plain forward of the state's current params, no backward and no
        state change. ``entropy_objective`` is the adapt step's entropy
        (mode and ``entropy_focus``), ``entropy_gate`` the plain volume-mean
        entropy (focus "all"), the drift detector; both reach the host in
        one copy."""
        thr = float(threshold)
        focus = self.entropy_focus

        @torch.no_grad()
        def forward_predict_fn(state, image, n_valid):
            image, w, denom = self._prepare(image, n_valid)
            with sp.sharded(self.mesh):
                logits = state(image)
            obj = entropy_loss(logits, sigmoid=self.sigmoid_mode, focus=focus, per_sample=True, space=self.space)
            gate = obj if focus == "all" else entropy_loss(logits, sigmoid=self.sigmoid_mode, focus="all",
                                                           per_sample=True, space=self.space)
            e = self.mesh.total(torch.stack([(obj * w).sum() / denom, (gate * w).sum() / denom])).tolist()
            return self._predict(logits, thr), e[0], e[1]

        return forward_predict_fn

    # ---- the pure serving step (serving/export.py) ------------------------
    # The reference's ``build_serving_step`` / ``serving_export_spec``: the
    # fused adapt+segment step as a pure function over a flat state, which
    # ``serving/export.py`` traces and saves. The state's leaves, in order:
    # every param of the model (``named_parameters``), its running statistics
    # (``running_statistics``; none without BatchNorm), the optimizer's state
    # over the adapted tensors (``_opt_leaves``), then the method's carry
    # (``_carry_leaves``: SAR's entropy EMA, CoTTA's teacher). The step takes
    # its random numbers as inputs (the flat ``batch_draws``, ``ops/augment.py``)
    # and reads nothing on the host: the early stop is a merge, as in the
    # reference's ``gated``. It shares the objective, the prediction and the
    # draws with the live step; the model's forwards read the step's values
    # through ``_run`` (``functional_call``), and a BatchNorm forward writes
    # its new running statistics into a copy that the step returns.

    def serving_post(self, mode: str) -> bool:
        """Whether a batch served in ``mode`` draws for a post-update
        ensemble prediction (Tent: never)."""
        return False

    def _opt_leaves(self, ts: Sequence[torch.Tensor]) -> List[Tuple[str, torch.Tensor]]:
        """The optimizer's initial state over the adapted tensors ``ts``:
        SGD's momentum buffers (none without momentum), Adam's first and
        second moments and its step count."""
        if self.opt_name == "sgd":
            return [(f"momentum:{n}", torch.zeros_like(t)) for n, t in zip(self._names, ts)] if self.momentum else []
        if self.opt_name == "adam":
            return ([(f"mu:{n}", torch.zeros_like(t)) for n, t in zip(self._names, ts)]
                    + [(f"nu:{n}", torch.zeros_like(t)) for n, t in zip(self._names, ts)]
                    + [("count", torch.zeros((), dtype=torch.float32, device=self.device))])
        raise ValueError(f"[tent] unsupported optimizer: {self.opt_name}")

    def _opt_update(self, ts, grads, opt) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """One optimizer update as a function, ``(new ts, new state)``, with
        the arithmetic of the live step's ``torch.optim`` SGD (dampening 0)
        and Adam (its defaults)."""
        if self.opt_name == "sgd":
            if not self.momentum:
                return [t.add(g, alpha=-self.lr) for t, g in zip(ts, grads)], []
            bufs = [b.mul(self.momentum).add(g) for b, g in zip(opt, grads)]
            return [t.add(b, alpha=-self.lr) for t, b in zip(ts, bufs)], bufs
        b1, b2, eps = 0.9, 0.999, 1e-8
        n = len(ts)
        count = opt[2 * n] + 1.0
        mu = [m.lerp(g, 1.0 - b1) for m, g in zip(opt[:n], grads)]
        nu = [v.mul(b2).addcmul(g, g, value=1.0 - b2) for v, g in zip(opt[n:2 * n], grads)]
        c = count.double()  # the bias corrections in f64, as torch.optim takes them on the host
        step = (-self.lr / (1.0 - b1 ** c)).float()
        bc2 = torch.sqrt(1.0 - b2 ** c).float()
        new = [t + step * m / (v.sqrt() / bc2 + eps) for t, m, v in zip(ts, mu, nu)]
        return new, mu + nu + [count]

    def _carry_leaves(self) -> List[Tuple[str, torch.Tensor]]:
        """The method's carried state at its source value (Tent: none)."""
        return []

    def _serving_leaves(self) -> List[Tuple[str, torch.Tensor]]:
        """The step's initial state as named leaves, in the documented order."""
        self._param_names = [n for n, _ in self._model.named_parameters()]
        stats = running_statistics(self._model)
        self._stat_names = list(stats)
        opt = self._opt_leaves(self._source)
        self._n_opt = len(opt)
        return ([(f"param:{n}", p.detach().clone()) for n, p in self._model.named_parameters()]
                + [(f"stat:{n}", t) for n, t in stats.items()] + [(f"opt:{n}", t) for n, t in opt]
                + self._carry_leaves())

    def _split_state(self, state):
        """``(params, stats, opt, carry)`` of a flat state: two dicts by name
        and two lists."""
        a = len(self._param_names)
        b = a + len(self._stat_names)
        c = b + self._n_opt
        return (dict(zip(self._param_names, state[:a])), dict(zip(self._stat_names, state[a:b])),
                list(state[b:c]), list(state[c:]))

    def _join_state(self, params, ts, stats, opt, carry) -> List[torch.Tensor]:
        """The flat state of ``params`` with the adapted ones replaced by
        ``ts``, then ``stats``, ``opt`` and ``carry``."""
        out = dict(params)
        out.update(zip(self._names, ts))
        return [out[n] for n in self._param_names] + [stats[n] for n in self._stat_names] + list(opt) + list(carry)

    @contextmanager
    def _pure_values(self, params, ts, stats):
        """The model's forwards inside the block read ``params`` with the
        adapted ones replaced by ``ts``, and the running statistics ``stats``
        (a BatchNorm forward that moves them writes into these tensors)."""
        values = dict(params)
        values.update(zip(self._names, ts))
        values.update(stats)
        held, self._values = self._values, values
        try:
            yield
        finally:
            self._values = held

    def _pure_step(self, state, image, draws, n_valid, ent_floor, thr: float, mode: str):
        """Tent's step: ``(state', ents [steps], pred uint8)``."""
        params, stats, opt, _ = self._split_state(state)
        image, w, denom = self._prepare(image, n_valid)
        ts = [params[n] for n in self._names]
        if self.episodic:
            opt = [t for _, t in self._opt_leaves(ts)]
        inline = mode == "inline"
        ents, logits = [], None
        e0 = torch.full((), float("nan"), device=image.device)
        active = torch.ones((), dtype=torch.bool, device=image.device)
        for i, d in enumerate(draws["steps"]):
            x = image
            if self.md_enabled and not (inline and i == self.steps - 1):
                x = apply_modality_dropout(x, d["drop"])
            leaves = [t.detach().requires_grad_() for t in ts]
            work = {k: v.clone() for k, v in stats.items()}
            with self._pure_values(params, leaves, work), torch.enable_grad():
                loss, logits = self._objective(x, d, w, denom)
                grads = torch.autograd.grad(loss, leaves)
            new_ts, new_opt = self._opt_update(ts, grads, opt)
            if d["restore"] is not None:
                new_ts = restored(new_ts, self._source, d["restore"])
            ent = loss.detach()
            ents.append(ent)
            if self.early_stop:
                # the reference's gated merge: a step below the floor, and
                # every step after it, leaves params, statistics and
                # optimizer state as they were (its forward and backward
                # still run)
                e0 = torch.where(torch.isnan(e0), ent, e0)
                floor = torch.where(torch.isnan(ent_floor), self.early_stop_ratio * e0, ent_floor)
                active = active & (ent >= floor)
                new_ts = [torch.where(active, a, b) for a, b in zip(new_ts, ts)]
                work = {k: torch.where(active, work[k], stats[k]) for k in stats}
                new_opt = [torch.where(active, a, b) for a, b in zip(new_opt, opt)]
            ts, stats, opt = new_ts, work, new_opt
        if inline:
            pred = self._predict(logits.detach(), thr)
        else:
            with self._pure_values(params, ts, stats), torch.no_grad():
                pred = self._predict(self._run(image), thr)
        return self._join_state(params, ts, stats, opt, []), torch.stack(ents), pred

    def serving_export_spec(self, source_model: nn.Module, threshold: float, predict_mode: str = "inline"):
        """The export protocol (``serving/export.py``): ``(call, state0,
        names)``. ``call(state, image, draws, n_valid, ent_floor) -> (state',
        ents [steps], pred uint8)`` is pure: ``state`` the flat leaves,
        ``draws`` the flat draws of ``batch_draw_spec(image.shape,
        serving_post(mode))``, ``n_valid`` an int32 and ``ent_floor`` an f32
        scalar tensor (NaN: the batch-relative floor). ``state0`` holds the
        source model's leaves and ``names`` theirs. Episodic mode starts the
        optimizer (and the carry) afresh inside the step; the runtime feeds
        ``state0`` again for every batch. Binds ``source_model`` as the
        ``make_*`` functions do; its values stay as they are."""
        mode = str(predict_mode or self.predict_mode).lower()
        self._check_predict_mode(mode)
        if self.fisher_enabled:
            raise ValueError(f"[{self.method}] the Fisher anchor is estimated on the host across "
                             "batches and has no pure serving step; set tta.fisher.enabled=false")
        if self.mesh.parallel:
            raise ValueError(
                f"[{self.method}] export is the single-device serving artifact; build the adapter "
                "without a mesh (a deployment over several devices replicates the artifact, it does "
                "not shard it)")
        self._bind(source_model)
        leaves = self._serving_leaves()
        thr = float(threshold)

        def call(state, image, draws, n_valid, ent_floor):
            spec = self.batch_draw_spec(tuple(image.shape), self.serving_post(mode))
            return self._pure_step(list(state), image, group_draws(spec, list(draws)), n_valid, ent_floor,
                                   thr, mode)

        return call, [t for _, t in leaves], [n for n, _ in leaves]

    def build_serving_step(self, source_model: nn.Module, threshold: float,
                           predict_mode: str = "inline") -> Callable:
        """The pure step over one flat tuple: ``step(*state, image, *draws,
        n_valid, ent_floor) -> (*state', ents, pred)``; ``serving_export_spec``
        says what each part is. Also returns ``state0``."""
        call, state0, _ = self.serving_export_spec(source_model, threshold, predict_mode)
        n = len(state0)

        def step(*args):
            *draws, n_valid, ent_floor = args[n + 1:]
            new, ents, pred = call(args[:n], args[n], draws, n_valid, ent_floor)
            return (*new, ents, pred)

        return step, state0
