"""Optimizer and learning-rate schedule factories over ``torch.optim`` (the
port of ``multimodal_tta_tpu/core/optim.py``).

The reference's optimizer surface: sgd/adam/adamw selected by
``training.optimizer``, per-optimizer kwarg blocks under
``training.optimizers.<name>``, weight decay excluded for bias/norm/1-D
params per ``training.param_groups`` rules (two param groups here), and the
epoch-stepped ``EpochScheduler`` (plain Python, the reference's word for
word). Each update rule is the torch optimizer that equals the reference's
optax chain:

  * sgd   — ``add_decayed_weights`` + ``optax.sgd`` (trace, nesterov):
            ``torch.optim.SGD(weight_decay=, momentum=, dampening=0)``
  * adam  — decay added to the gradient (L2) + ``optax.adam``:
            ``torch.optim.Adam(weight_decay=)``
  * adamw — ``optax.adamw`` (decoupled decay): ``torch.optim.AdamW``
  * adafactor — ``add_decayed_weights`` + ``optax.adafactor`` with the
            reference's keys: ``Adafactor`` below, written out (torch's
            own Adafactor is another algorithm: its decay, epsilons and
            relative step differ); over a model or expert axis it reads
            each cut tensor whole through sums over the cut's group

``training.grad_accum = k`` wraps the optimizer in ``MultiSteps``, the
counterpart of ``optax.MultiSteps``: the running mean of k gradients is
applied once every k-th step, and the inner optimizer's state (Adam's
count included) moves only then. The learning rate is a param-group value
that the trainer sets per epoch (``set_learning_rate``), as the reference
injects it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

import numpy as np

from ..conf.node import ConfigNode
from ..models.convert import flax_cut_dim, flax_layouts, flax_leaf_of, flax_path, from_flax, nest, transposed_kernels
from ..parallel.tensor import sharded_params, update_rule
from ..utils.config import get_config
from .flax_msgpack import Fields, TupleFields


def no_decay_mask(model: nn.Module, no_decay_keys, treat_1d: bool = True) -> Dict[str, bool]:
    """``{param name: weight decay APPLIES}``.

    A param is excluded from decay when any configured key is a substring of
    its path, or when it is 1-D (bias/scale) and treat_1d is set — the
    reference's rules, decided on the flax path that ``models/convert.py``
    maps each torch parameter to (``...conv.weight`` is ``.../conv/kernel``),
    not on the torch name."""
    keys = [str(k).lower() for k in (no_decay_keys or [])]

    def decide(name: str, p: torch.Tensor) -> bool:
        path = flax_path(name).lower()
        if any(k in path for k in keys):
            return False
        if treat_1d and p.dim() <= 1:
            return False
        return True

    return {name: decide(name, p) for name, p in model.named_parameters()}


class MultiSteps:
    """Gradient accumulation over a torch optimizer (``optax.MultiSteps``
    with ``use_grad_mean``): each ``step()`` folds the params' ``.grad`` into
    a running mean ``acc + (g - acc) / (n + 1)``; the k-th hands the mean to
    the inner optimizer, steps it and resets. ``step()`` returns whether the
    params were updated; ``gradient_step`` counts the updates, as optax's
    ``MultiStepsState.gradient_step`` does."""

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int):
        self.optimizer = optimizer
        self.every_k = int(every_k)
        self.mini_step = 0
        self.gradient_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    @property
    def param_groups(self) -> List[Dict[str, Any]]:
        return self.optimizer.param_groups

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> bool:
        params = self._params()
        if self.acc is None:
            self.acc = [torch.zeros_like(p) for p in params]
        n = self.mini_step
        for p, a in zip(params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            a.add_((g - a) / (n + 1))
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step != 0:
            return False
        for p, a in zip(params, self.acc):
            p.grad = a.clone()
            a.zero_()
        self.optimizer.step()
        self.gradient_step += 1
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"inner": self.optimizer.state_dict(), "mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "acc": None if self.acc is None else [a.clone() for a in self.acc]}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(sd["inner"])
        self.mini_step = int(sd["mini_step"])
        self.gradient_step = int(sd.get("gradient_step", 0))  # a .pt written before it was counted: 0
        acc = sd.get("acc")
        self.acc = None if acc is None else [
            a.to(device=p.device, dtype=p.dtype).clone() for a, p in zip(acc, self._params())]


def factored_dims(shape, min_dim_size_to_factor: int) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: ``(d1, d0)``, the second-largest and the
    largest axis of ``shape``, or None when fewer than two axes reach
    ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(torch.optim.Optimizer):
    """The reference's Adafactor chain (``multimodal_tta_tpu/core/optim.py``):
    ``add_decayed_weights`` (the group's ``weight_decay``, added to the
    gradient) then ``optax.adafactor``: the factored second moment with
    ``beta2_t = 1 - (t + 1)^-decay_rate`` and epsilon 1e-30
    (``scale_by_factored_rms``), update clipping by block RMS
    (``clipping_threshold``), the learning rate, optionally
    ``multiply_by_parameter_scale`` (``max(rms(p), 1e-3)``) and momentum
    (an EMA of the updates, not debiased), all per parameter.

    A parameter is read in its flax layout (``layouts``: ``flax_layouts``),
    so the moments factor the axes the reference factors: optax picks the
    two largest axes of the flax shape, and a torch conv kernel
    ``[out, in, k, k, k]`` is flax's ``[k, k, k, in, out]``. The learning
    rate is the param group's, so ``set_learning_rate`` and ``MultiSteps``
    act as they do for Adam. A parameter without a gradient takes a zero
    one, as every leaf of the reference has a gradient.

    A parameter that this rank holds a share of over a model or expert axis
    (``cuts``: ``{id: (torch dim, flax axis, ShardAxis)}``) is read as the
    whole tensor the reference reads: its factored axes are chosen on the
    whole flax shape, a row or column statistic taken along the cut axis and
    the block RMS of the clip (and of ``multiply_by_parameter_scale``) sum
    their squares over the cut's group, and a statistic along another axis
    (one per expert, say) is this rank's own."""

    def __init__(self, params, lr: float, layouts: Dict[int, Tuple[Tuple[int, ...], Tuple[int, ...]]],
                 min_dim_size_to_factor: int = 128, decay_rate: float = 0.8, momentum: Optional[float] = None,
                 clipping_threshold: Optional[float] = 1.0, multiply_by_parameter_scale: bool = False,
                 eps: float = 1e-30, cuts: Optional[Dict[int, tuple]] = None):
        super().__init__(params, dict(lr=lr, weight_decay=0.0))
        self.layouts = layouts
        self.cuts = cuts or {}
        self.min_dim_size_to_factor = int(min_dim_size_to_factor)
        self.decay_rate, self.momentum, self.eps = float(decay_rate), momentum, float(eps)
        self.clipping_threshold = clipping_threshold
        self.multiply_by_parameter_scale = bool(multiply_by_parameter_scale)

    def _layout(self, p: torch.Tensor):
        return self.layouts.get(id(p), (tuple(range(p.dim())), tuple(p.shape)))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if wd:
                    g = g + wd * p
                self._update(p, g, lr)

    def _dims(self, p: torch.Tensor):
        """``(dims, c, axis)``: the factored axes of the whole flax shape,
        and the flax axis cut over ``axis`` (None, None: whole)."""
        perm, shape = self._layout(p)
        if id(p) not in self.cuts:
            return factored_dims(shape, self.min_dim_size_to_factor), None, None
        _, c, axis = self.cuts[id(p)]
        whole = list(shape)
        whole[c] *= axis.size
        return factored_dims(whole, self.min_dim_size_to_factor), c, axis

    def state_cut(self, p: torch.Tensor, key: str) -> Optional[int]:
        """The dim of state ``key`` of a cut param ``p`` that is cut over its
        axis (None: the state is whole or scalar): ``mu`` in the param's
        layout, ``v`` / ``v_row`` / ``v_col`` in its flax layout."""
        if key == "mu":
            return self.cuts[id(p)][0]
        dims, c, _ = self._dims(p)
        if key == "v":
            return c
        if key not in ("v_row", "v_col") or c == dims[key == "v_row"]:
            return None  # v_row drops axis d0, v_col drops d1
        return c - (c > dims[key == "v_row"])

    @staticmethod
    def _mean(t: torch.Tensor, dim: Optional[int], cut: Optional[int], axis) -> torch.Tensor:
        """``t.mean(dim)`` (``dim`` None: of every element) of a tensor whose
        axis ``cut`` holds this rank's share over ``axis``: the squares'
        sums meet over the group when the mean reads the cut axis."""
        if cut is None or (dim is not None and dim != cut):
            return t.mean() if dim is None else t.mean(dim=dim)
        s = t.sum() if dim is None else t.sum(dim=dim)
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=axis.group)
        return s / ((t.numel() if dim is None else t.shape[dim]) * axis.size)

    def _update(self, p: torch.Tensor, g: torch.Tensor, lr: float) -> None:
        perm, shape = self._layout(p)
        gf = g.permute(perm).reshape(shape)
        dims, c, axis = self._dims(p)
        state = self.state[p]
        if not state:
            state["step"] = 0
            if dims is None:
                state["v"] = torch.zeros(shape, dtype=p.dtype, device=p.device)
            else:
                d1, d0 = dims
                state["v_row"] = torch.zeros([s for i, s in enumerate(shape) if i != d0], dtype=p.dtype,
                                             device=p.device)
                state["v_col"] = torch.zeros([s for i, s in enumerate(shape) if i != d1], dtype=p.dtype,
                                             device=p.device)
            if self.momentum is not None:
                state["mu"] = torch.zeros_like(p, dtype=torch.float32)
        # beta2_t in f32, as optax's _decay_rate_pow (a host scalar: no copy to the device)
        beta = float(np.float32(1.0) - np.float32(state["step"] + 1) ** np.float32(-self.decay_rate))
        grad_sqr = gf * gf + self.eps
        if dims is None:
            v = beta * state["v"] + (1.0 - beta) * grad_sqr
            state["v"] = v
            u = gf * v ** -0.5
        else:
            d1, d0 = dims
            v_row = beta * state["v_row"] + (1.0 - beta) * self._mean(grad_sqr, d0, c, axis)
            v_col = beta * state["v_col"] + (1.0 - beta) * self._mean(grad_sqr, d1, c, axis)
            state["v_row"], state["v_col"] = v_row, v_col
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            c_row = self.state_cut(p, "v_row") if c is not None else None
            row_mean = self._mean(v_row, reduced_d1, c_row, axis).unsqueeze(reduced_d1)
            row_factor = (v_row / row_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = gf * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        state["step"] += 1
        if self.clipping_threshold is not None:
            u = u / torch.clamp(torch.sqrt(self._mean(u * u, None, c, axis)) / self.clipping_threshold, min=1.0)
        u = u * lr
        if self.multiply_by_parameter_scale:
            u = u * torch.clamp(torch.sqrt(self._mean(p * p, None, c, axis)), min=1e-3)
        u = u.reshape(p.permute(perm).shape).permute(*np.argsort(perm).tolist())  # the parameter's layout
        if self.momentum is not None:
            mu = (1.0 - self.momentum) * u + self.momentum * state["mu"]
            state["mu"] = mu
            u = mu
        p.sub_(u)


Optimizer = Union[torch.optim.Optimizer, MultiSteps]


def build_optimizer(training_cfg, model: nn.Module, mesh=None) -> Tuple[Optimizer, float]:
    """Build the optimizer over ``model``'s trainable params; returns
    ``(optimizer, base_lr)``. With ``training.zero1`` and a data axis of
    more than one rank (``mesh``), the optimizer's state is partitioned over
    the ranks (``parallel/mesh.py:zero1_optimizer``), also under
    ``grad_accum`` and for Adafactor."""
    opt_name = str(get_config(training_cfg, "optimizer", "sgd")).lower()
    if opt_name not in ("sgd", "adam", "adamw", "adafactor"):
        raise ValueError(f"Unsupported optimizer: {opt_name}")
    blocks = get_config(training_cfg, "optimizers", ConfigNode())
    opt_cfg = get_config(blocks, opt_name, ConfigNode())

    lr = float(get_config(opt_cfg, "lr", get_config(training_cfg, "learning_rate", 1e-3)))
    wd = float(get_config(opt_cfg, "weight_decay", get_config(training_cfg, "weight_decay", 0.0)))

    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if wd > 0:
        pg = get_config(training_cfg, "param_groups", ConfigNode())
        mask = no_decay_mask(model, get_config(pg, "no_decay_keys", []),
                             bool(get_config(pg, "treat_1d_as_no_decay", True)))
        groups = [{"params": [p for n, p in params if mask[n]], "weight_decay": wd},
                  {"params": [p for n, p in params if not mask[n]], "weight_decay": 0.0}]
        groups = [g for g in groups if g["params"]]
    else:
        groups = [{"params": [p for _, p in params], "weight_decay": 0.0}]

    if opt_name == "sgd":
        momentum = float(get_config(opt_cfg, "momentum", get_config(training_cfg, "momentum", 0.0)))
        nesterov = bool(get_config(opt_cfg, "nesterov", False)) and momentum > 0
        cls, kw = torch.optim.SGD, dict(lr=lr, momentum=momentum, dampening=0.0, nesterov=nesterov)
    elif opt_name == "adafactor":
        momentum = get_config(opt_cfg, "momentum", None)
        layouts = flax_layouts(model)
        cuts = {}  # a param this rank holds a share of: its cut in both layouts, and the axis
        for n, (dim, axis) in sharded_params(model).items():
            p = dict(params).get(n)
            if p is not None:
                perm, fshape = layouts[n]
                cuts[id(p)] = (dim, flax_cut_dim(perm, p.shape, fshape, dim), axis)
        cls, kw = Adafactor, dict(
            lr=lr, layouts={id(p): layouts[n] for n, p in params}, cuts=cuts,
            min_dim_size_to_factor=int(get_config(opt_cfg, "min_dim_size_to_factor", 128)),
            decay_rate=float(get_config(opt_cfg, "decay_rate", 0.8)),
            momentum=None if momentum in (None, 0, 0.0, False, "none") else float(momentum),
            clipping_threshold=float(get_config(opt_cfg, "clipping_threshold", 1.0)),
            multiply_by_parameter_scale=bool(get_config(opt_cfg, "multiply_by_parameter_scale", False)))
    else:
        betas = get_config(opt_cfg, "betas", [0.9, 0.999])
        eps = float(get_config(opt_cfg, "eps", 1e-8))
        cls = torch.optim.Adam if opt_name == "adam" else torch.optim.AdamW
        kw = dict(lr=lr, betas=(float(betas[0]), float(betas[1])), eps=eps)
    if bool(get_config(training_cfg, "zero1", False)) and mesh is not None and mesh.parallel:
        from ..parallel.mesh import zero1_optimizer

        tx: torch.optim.Optimizer = zero1_optimizer(cls, groups, mesh, **kw)
    else:
        tx = cls(groups, **kw)

    accum = int(get_config(training_cfg, "grad_accum", 1))
    if accum < 1:
        raise ValueError(f"training.grad_accum must be >= 1, got {accum}")
    if accum > 1:
        return MultiSteps(tx, accum), lr
    return tx, lr


def set_learning_rate(optimizer: Optimizer, lr: float) -> Optimizer:
    """Set the learning rate of every param group (through ``MultiSteps``)."""
    for g in optimizer.param_groups:
        g["lr"] = float(lr)
    return optimizer


def get_learning_rate(optimizer: Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


# ---------------------------------------------------------------------------
# The optax state of the reference's chain, for checkpoints in its msgpack
# format (core/checkpoint.py). The tree is what
# multimodal_tta_tpu/core/optim.py:build_optimizer builds for the same
# ``training`` node, read off the optimizer that ``build_optimizer`` made
# from it: inject_hyperparams' count and learning rate; the masked
# add_decayed_weights, present when a group decays; the update rule's state
# (SGD's trace, Adam's and AdamW's count/mu/nu, Adafactor's
# count/v_row/v_col/v and its momentum's EMA); optax.MultiSteps around it
# all under ``grad_accum``. A NamedTuple or tuple state is a ``Fields`` (its
# fields in order), a tree over the params a plain dict in the params' flax
# layout.


class _Slot:
    """A leaf of the optax tree: ``key`` names what it holds; ``per_param``:
    a tree over the params (else a scalar)."""

    def __init__(self, key: str, per_param: bool = False):
        self.key, self.per_param = key, per_param


def _chain(*parts) -> TupleFields:
    return TupleFields((str(i), p) for i, p in enumerate(parts))


def optax_tree(optimizer: Optimizer) -> Fields:
    """The optax state's tree for ``optimizer``, its leaves ``_Slot``s."""
    rule, S = update_rule(optimizer), _Slot
    decay = any(float(g.get("weight_decay", 0.0)) > 0 for g in optimizer.param_groups)
    masked = Fields(inner_state=Fields())  # add_decayed_weights under its mask
    adam = Fields(count=S("count"), mu=S("exp_avg", True), nu=S("exp_avg_sq", True))
    if isinstance(rule, torch.optim.AdamW):  # optax.adamw carries the decay itself
        parts = [_chain(adam, masked if decay else Fields(), Fields())]
        decay = False
    elif isinstance(rule, torch.optim.Adam):
        parts = [_chain(adam, Fields())]
    elif isinstance(rule, torch.optim.SGD):
        trace = Fields(trace=S("momentum_buffer", True)) if rule.param_groups[0]["momentum"] else Fields()
        parts = [_chain(trace, Fields())]
    elif isinstance(rule, Adafactor):
        factored = [Fields(count=S("count"), v_row=S("v_row", True), v_col=S("v_col", True), v=S("v", True))]
        factored += [Fields()] * ((rule.clipping_threshold is not None) + 1 + rule.multiply_by_parameter_scale)
        if rule.momentum is not None:
            factored.append(Fields(count=S("count"), ema=S("mu", True)))
        parts = [_chain(*factored, Fields())]
    else:
        raise TypeError(f"[optim] no optax state for {type(rule).__name__}")
    tree = Fields(count=S("updates"), hyperparams={"learning_rate": S("learning_rate")}, hyperparams_states={},
                  inner_state=_chain(*([masked] if decay else []), *parts))
    if isinstance(optimizer, MultiSteps):
        tree = Fields(mini_step=S("mini_step"), gradient_step=S("gradient_step"), inner_opt_state=tree,
                      acc_grads=S("acc", True), skip_state=TupleFields())
    return tree


def _param_names(model: nn.Module, optimizer: Optimizer) -> List[str]:
    """The param names in the order of the optimizer's state-dict indices."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _stat_flips(dims, ndim: int, flip: bool) -> Dict[str, List[int]]:
    """The axes of ``v_row``, ``v_col`` and ``v`` that flip between the
    port and optax. The port reads a transposed conv's kernel in its flax
    layout unflipped (``flax_layouts``), optax flipped in space (``flip``):
    each statistic flips the spatial axes it keeps (``dims``: the factored
    ``(d1, d0)`` or None)."""
    spatial = list(range(ndim - 2)) if flip else []
    if dims is None:
        return {"v": spatial}
    d1, d0 = dims
    return {"v_row": [i - (i > d0) for i in spatial if i != d0], "v_col": [i - (i > d1) for i in spatial if i != d1]}


def _adafactor_stats(rule, fshape, dtype, entry: dict, flip: bool) -> Dict[str, torch.Tensor]:
    """``v_row``, ``v_col`` and ``v`` of one param (whole flax shape
    ``fshape``) as optax keeps them: the statistics the port keeps (zeros
    before the first step), and ``(1,)`` zeros where optax keeps a
    placeholder."""
    dims = factored_dims(fshape, rule.min_dim_size_to_factor)
    if dims is None:
        shapes = {"v": fshape}
    else:
        d1, d0 = dims
        shapes = {"v_row": [s for i, s in enumerate(fshape) if i != d0],
                  "v_col": [s for i, s in enumerate(fshape) if i != d1]}
    flips = _stat_flips(dims, len(fshape), flip)
    out = {}
    for k in ("v_row", "v_col", "v"):
        t = entry[k] if k in entry and k in shapes else torch.zeros(shapes.get(k, (1,)), dtype=dtype)
        out[k] = t.flip(flips[k]) if flips.get(k) else t
    return out


def optax_state(optimizer: Optimizer, model: nn.Module, *, step: int, state_dict: Optional[dict] = None,
                params: Optional[Dict[str, torch.Tensor]] = None) -> Fields:
    """The reference's optax state (``optax_tree``) of ``optimizer`` over
    ``model``: ``state_dict`` (default the optimizer's own) and ``params``
    (default the model's) whole, as ``core/checkpoint.py`` gathers them over
    a model axis or consolidates them under ZeRO-1. ``step`` is the train
    state's (inject_hyperparams counts every update: under ``MultiSteps``
    the applied ones). A param without state (no step taken yet) holds
    optax's initial zeros."""
    sd = optimizer.state_dict() if state_dict is None else state_dict
    multi = isinstance(optimizer, MultiSteps)
    inner_sd = sd["inner"] if multi else sd
    names = _param_names(model, optimizer)
    entries = {names[int(i)]: e for i, e in inner_sd["state"].items() if e}
    acc = dict(zip(names, sd.get("acc") or [])) if multi else {}
    whole = params if params is not None else {n: p.detach() for n, p in model.named_parameters()}
    leaf, rule = flax_leaf_of(model), update_rule(optimizer)
    counts = [int(e["step"]) for e in entries.values() if "step" in e]
    updates = sd["gradient_step"] if multi else step
    adafactor, flipped = {}, transposed_kernels(model)
    if isinstance(rule, Adafactor):
        for n, p in whole.items():
            fshape = list(leaf(n, torch.empty(p.shape, device="meta")).shape)
            adafactor[n] = _adafactor_stats(rule, fshape, p.dtype, entries.get(n, {}), n in flipped)
    scalars = {"updates": np.asarray(updates, np.int32), "count": np.asarray(max(counts, default=0), np.int32),
               "learning_rate": np.asarray(get_learning_rate(optimizer), np.float32),
               "mini_step": np.asarray(sd.get("mini_step", 0), np.int32),
               "gradient_step": np.asarray(sd.get("gradient_step", 0), np.int32)}

    def per_param(key: str) -> dict:
        out = {}
        for n, p in whole.items():
            if key in ("v_row", "v_col", "v"):  # kept in the flax layout
                out[flax_path(n)] = adafactor[n][key]
                continue
            t = acc.get(n) if key == "acc" else entries.get(n, {}).get(key)
            if t is None:
                t = torch.zeros_like(p, dtype=torch.float32 if key == "mu" else p.dtype)
            out[flax_path(n)] = leaf(n, t)
        return nest(out, "/")

    def fill(node):
        if isinstance(node, _Slot):
            return per_param(node.key) if node.per_param else scalars[node.key]
        return type(node)((k, fill(v)) for k, v in node.items())

    return fill(optax_tree(optimizer))


def load_optax_state(optimizer: Optimizer, model: nn.Module, tree: dict, *,
                     learning_rate: Optional[float] = None) -> dict:
    """The optimizer state dict, whole (``parallel/tensor.py:optimizer_state``
    cuts it), of the reference's optax state ``tree`` for ``optimizer``
    over ``model``; raises when the tree is not what ``optax_tree`` gives
    for it. The learning rate is the tree's float32 value, or
    ``learning_rate`` where that rounds to it (the exact value a port run
    kept). Before the first update the per-param state is left empty, as
    a fresh torch optimizer's is."""
    slots: Dict[str, Any] = {}

    def match(want, got, path: str) -> None:
        if isinstance(want, _Slot):
            slots[want.key] = got
            return
        if not isinstance(got, dict) or set(got) != set(want):
            have = sorted(got) if isinstance(got, dict) else type(got).__name__
            raise ValueError(f"[checkpoint] the optimizer state at opt_state{path} holds {have}; "
                             f"this run's {type(update_rule(optimizer)).__name__} keeps {sorted(want)}")
        for k, v in want.items():
            match(v, got[k], f"{path}/{k}")

    match(optax_tree(optimizer), tree, "")
    rule, multi = update_rule(optimizer), isinstance(optimizer, MultiSteps)
    names = _param_names(model, optimizer)
    lr = float(np.float32(slots["learning_rate"]))
    if learning_rate is not None and np.float32(learning_rate) == np.float32(lr):
        lr = float(learning_rate)
    count = int(slots["count"]) if "count" in slots else 0
    moments = {k: from_flax(v) for k, v in slots.items() if k in ("exp_avg", "exp_avg_sq", "momentum_buffer", "mu")}
    step_dtype = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    leaf, flipped = flax_leaf_of(model), transposed_kernels(model)
    params = dict(model.named_parameters())
    state = {}
    # before the first update optax holds its initial zeros, torch no state
    for i, n in enumerate(names if int(slots["updates"]) else ()):
        entry = {}  # in the order torch's own update rules fill it
        if isinstance(rule, torch.optim.Adam):
            entry["step"] = torch.tensor(float(count), dtype=step_dtype)
        elif isinstance(rule, Adafactor):
            entry["step"] = count
            node = {k: slots[k] for k in ("v_row", "v_col", "v")}
            for part in flax_path(n).split("/"):
                node = {k: v[part] for k, v in node.items()}
            p = params[n]
            ndim = leaf(n, torch.empty(p.shape, device="meta")).dim()
            flips = _stat_flips(rule._dims(p)[0], ndim, n in flipped)  # factored on the whole flax shape
            if any(node[k].dim() != ndim - (k != "v") for k in flips):
                raise ValueError(f"[checkpoint] the Adafactor statistics of {n} in the file are "
                                 f"{ {k: tuple(v.shape) for k, v in node.items()} }; this run keeps {sorted(flips)} "
                                 f"(min_dim_size_to_factor {rule.min_dim_size_to_factor})")
            entry.update({k: node[k].flip(axes) if axes else node[k] for k, axes in flips.items()})
        entry.update({k: v[n] for k, v in moments.items()})
        if entry:
            state[i] = entry
    groups, start = [], 0
    for g in optimizer.param_groups:
        groups.append(dict({k: v for k, v in g.items() if k != "params"}, lr=lr,
                           params=list(range(start, start + len(g["params"])))))
        start += len(g["params"])
    out = {"state": state, "param_groups": groups}
    if multi:
        acc = from_flax(slots["acc"])
        out = {"inner": out, "mini_step": int(slots["mini_step"]), "gradient_step": int(slots["gradient_step"]),
               "acc": [acc[n] for n in names]}
    return out


class EpochScheduler:
    """Epoch-indexed LR schedule with the reference's scheduler vocabulary
    (reference: src/core/experiment_manager.py:275-316)."""

    def __init__(self, training_cfg, base_lr: float):
        sched_cfg = get_config(training_cfg, "scheduler", ConfigNode())
        self.name = str(get_config(sched_cfg, "name", "none")).lower()
        args = get_config(sched_cfg, "args", ConfigNode())
        self.base_lr = float(base_lr)
        self.epochs = int(get_config(training_cfg, "epochs", 200))

        self.milestones = [int(m) for m in get_config(args, "milestones", get_config(training_cfg, "milestones", [100, 150]))]
        self.gamma = float(get_config(args, "gamma", get_config(training_cfg, "gamma", 0.1)))
        self.step_size = int(get_config(args, "step_size", get_config(training_cfg, "step_size", 30)))
        # "poly": the nnU-Net standard for these workloads —
        # lr * (1 - epoch/epochs)^power, power 0.9
        self.power = float(get_config(args, "power", get_config(training_cfg, "power", 0.9)))
        # linear warmup over the first N epochs: lr * (e+1)/N, composing
        # with ANY schedule name (including "none") — the schedule's own
        # index keeps running during warmup, warmup just caps the ramp
        self.warmup_epochs = int(get_config(args, "warmup_epochs",
                                            get_config(training_cfg, "warmup_epochs", 0)))

        rop = get_config(args, "reduce_on_plateau", get_config(training_cfg, "reduce_on_plateau", ConfigNode()))
        self.rop_factor = float(get_config(rop, "factor", 0.1))
        self.rop_patience = int(get_config(rop, "patience", 10))
        self.rop_min_lr = float(get_config(rop, "min_lr", 1e-7))
        self._rop_best = float("inf")
        self._rop_bad = 0
        self._rop_lr = self.base_lr

    @property
    def enabled(self) -> bool:
        return self.name not in ("none", "") or self.warmup_epochs > 0

    def lr_for_epoch(self, epoch: int, val_loss: Optional[float] = None) -> float:
        """LR to use for epoch ``epoch`` (0-based), stepped per epoch."""
        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            return self.base_lr * (epoch + 1) / self.warmup_epochs
        if self.name in ("none", ""):
            return self.base_lr
        if self.name == "poly":
            t = min(epoch, self.epochs) / max(1, self.epochs)
            return self.base_lr * (1.0 - t) ** self.power
        if self.name == "multistep":
            k = sum(1 for m in self.milestones if epoch >= m)
            return self.base_lr * (self.gamma ** k)
        if self.name == "step":
            return self.base_lr * (self.gamma ** (epoch // self.step_size))
        if self.name == "cosine":
            t = min(epoch, self.epochs) / max(1, self.epochs)
            return 0.5 * self.base_lr * (1 + math.cos(math.pi * t))
        if self.name == "reduce_on_plateau":
            if val_loss is not None:
                if val_loss < self._rop_best:
                    self._rop_best = val_loss
                    self._rop_bad = 0
                else:
                    self._rop_bad += 1
                    if self._rop_bad > self.rop_patience:
                        self._rop_lr = max(self._rop_lr * self.rop_factor, self.rop_min_lr)
                        self._rop_bad = 0
            return self._rop_lr
        # unknown names -> no scheduling (same leniency as the reference)
        return self.base_lr

    def state_dict(self) -> Dict[str, Any]:
        return {
            "rop_best": self._rop_best,
            "rop_bad": self._rop_bad,
            "rop_lr": self._rop_lr,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._rop_best = float(sd.get("rop_best", float("inf")))
        self._rop_bad = int(sd.get("rop_bad", 0))
        self._rop_lr = float(sd.get("rop_lr", self.base_lr))
