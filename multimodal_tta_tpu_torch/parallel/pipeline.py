"""Pipeline parallelism over the mesh ``stage`` axis, GPipe's schedule (the
port of ``multimodal_tta_tpu/parallel/pipeline.py``).

The reference runs the whole pipeline as one SPMD program: ``shard_map``
gives each device its stage's stacked layers, a ``lax.scan`` over
``n_micro + S - 1`` ticks runs them, ``ppermute`` hops each tick's output to
the next stage, and ``jax.grad`` through the scan is the GPipe backward.
Here each rank is a process (``Mesh``: the stage index varies fastest, so a
stage group is ``S`` neighbouring ranks) and ``_Schedule``, one
``torch.autograd.Function`` over the whole schedule, does what the scan and
its transpose do:

  * forward: stage ``s`` holds layers ``[s*L/S, (s+1)*L/S)``; at tick ``t``
    it runs microbatch ``t - s`` (stage 0 feeds it, a later stage receives
    it from its predecessor) and sends its output to stage ``s + 1``; it
    keeps only its stage input of each microbatch. The last stage's outputs
    are broadcast over the stage group, as the reference's masked ``psum``
    replicates them;
  * backward: the reverse ticks. Stage ``s`` takes the gradient of its
    microbatch's output (the last stage from the caller, seeded once though
    every stage holds the output; the others from stage ``s + 1``),
    recomputes its layers' forward from the kept input (GPipe's remat;
    ``remat=True`` also checkpoints each layer inside that recompute, the
    reference's per-layer policy), accumulates its layers' gradients and
    sends the input's gradient to stage ``s - 1``. Stage 0's input
    gradient is broadcast over the stage group, so the whole layers before
    the trunk (an embedding) get the same gradient on every stage.

The hop is ``torch.distributed.send`` / ``recv`` between neighbours. NCCL
sends a CUDA tensor directly; gloo's point-to-point takes CPU tensors only
(given a CUDA tensor it writes from the device pointer as host memory and
aborts the sending process), so where ranks share a card (gloo) a CUDA hop
is staged through a pinned host buffer on each side.

Over a data axis each data rank runs its rows of every microbatch (the
reference's ``P(None, data)``). ``pipeline_apply`` takes and returns the
global batch, as the reference does: the outputs are gathered over the data
group (differentiably: each rank's own rows take their gradient), so a loss
of the gathered batch is the same on every rank, and the layers' gradients
of a rank are its rows' share: ``pipeline_value_and_grad`` sums them over the
data group and over the stage group (each stage holds its layers' part), so
every rank returns the whole stacked gradient.
``make_pipeline_train_step`` keeps each stage's layers and optimizer state
on that stage alone (``stage_params``): only the activation hops and the
data group's gradient sum cross ranks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .mesh import DATA_AXIS, STAGE_AXIS
from .space import all_gather_cat

Params = Dict[str, torch.Tensor]


def _flatten(tree: Mapping, prefix: str = "") -> Params:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.as_tensor(v)
    return out


def stack_layer_params(params: Mapping[str, Any], prefix: str, n_layers: int) -> Params:
    """Stack the per-layer params ``{prefix}0 .. {prefix}{n-1}`` into one
    tree with a leading layer axis, ``{name: [L, ...]}`` (differentiable:
    the stack's gradient reaches each layer's tensors). ``params`` holds
    each layer as a nested mapping (flax's tree), or flat under dotted names
    (a module's ``named_parameters``, where the port's ViT names its blocks
    ``block{i}``, as flax does)."""
    layers = []
    for i in range(n_layers):
        key = f"{prefix}{i}"
        if key in params:
            layers.append(_flatten(params[key]))
            continue
        flat = {k[len(key) + 1:]: torch.as_tensor(v) for k, v in params.items() if k.startswith(key + ".")}
        if not flat:
            raise KeyError(f"layer params {key!r} not found")
        layers.append(flat)
    if any(set(layer) != set(layers[0]) for layer in layers):
        raise ValueError(f"the layers {prefix}0..{prefix}{n_layers - 1} hold different params")
    return {name: torch.stack([layer[name] for layer in layers]) for name in layers[0]}


def _check(mesh, n_layers: int, b: int, n_micro: int, data_axis: Optional[str]) -> bool:
    """The reference's checks (its messages); returns whether the
    microbatches split over a data axis."""
    shape = mesh.shape if mesh is not None else {}
    n_stages = int(shape.get(STAGE_AXIS, 1))
    if n_stages <= 1:
        raise ValueError("pipeline_apply requires a mesh with a stage axis > 1")
    if n_layers % n_stages != 0:
        raise ValueError(f"layer count {n_layers} not divisible by {n_stages} stages")
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    has_data = data_axis is not None and shape.get(data_axis, 1) > 1
    if has_data:
        d = int(shape[data_axis])
        if (b // n_micro) % d != 0:
            raise ValueError(
                f"microbatch {b}//{n_micro}={b // n_micro} not divisible by "
                f"the {data_axis} axis extent {d}"
            )
    return has_data


def stage_params(mesh, stacked_params: Mapping[str, torch.Tensor]) -> Params:
    """This stage's layers of a whole stacked tree, as new leaf tensors (what
    ``make_pipeline_train_step``'s optimizer updates)."""
    n_stages, s = mesh.stage, mesh.stage_rank
    n_layers = next(iter(stacked_params.values())).shape[0]
    if n_layers % n_stages:
        raise ValueError(f"layer count {n_layers} not divisible by {n_stages} stages")
    k = n_layers // n_stages
    return {n: v.detach()[s * k:(s + 1) * k].clone().requires_grad_(v.requires_grad)
            for n, v in stacked_params.items()}


def gather_stages(mesh, params: Mapping[str, torch.Tensor]) -> Params:
    """The whole stacked tree from each stage's layers (every rank of the
    stage group takes part)."""
    return {n: all_gather_cat(v.detach().contiguous(), 0, mesh.stage, mesh.stage_group) for n, v in params.items()}


class _Plan:
    """What ``_Schedule`` runs: the mesh, the layer function, this stage's
    param names, the recompute policy, and the hop's staging buffers."""

    def __init__(self, mesh, layer_fn: Callable, names: List[str], n_micro: int, remat: bool):
        self.mesh, self.layer_fn, self.names, self.n_micro, self.remat = mesh, layer_fn, names, n_micro, remat
        self.n_stages, self.s = mesh.stage, mesh.stage_rank
        self.staged = dist.get_backend() != "nccl"  # gloo: a CUDA hop goes through pinned host memory
        self._host: Dict[Tuple, torch.Tensor] = {}

    def stage(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """This stage's layers, in order, on ``h``."""
        n = next(iter(params.values())).shape[0]
        for j in range(n):
            layer = {k: v[j] for k, v in params.items()}
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(self.layer_fn, layer, h, use_reentrant=False)
            else:
                h = self.layer_fn(layer, h)
        return h

    def _buffer(self, like: torch.Tensor, key: str) -> torch.Tensor:
        k = (key, tuple(like.shape), like.dtype)
        if k not in self._host:
            self._host[k] = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return self._host[k]

    def send(self, t: torch.Tensor, stage: int) -> None:
        dst = self.mesh.global_rank(stage=stage)
        if t.is_cuda and self.staged:
            t = self._buffer(t, "send").copy_(t)
        dist.send(t.contiguous(), dst)

    def recv(self, like: torch.Tensor, stage: int) -> torch.Tensor:
        src = self.mesh.global_rank(stage=stage)
        if like.is_cuda and self.staged:
            host = self._buffer(like, "recv")
            dist.recv(host, src)
            return host.to(like.device)
        out = torch.empty_like(like)
        dist.recv(out, src)
        return out

    def broadcast(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        dist.broadcast(t, src=self.mesh.global_rank(stage=stage), group=self.mesh.stage_group)
        return t

    def ticks(self, reverse: bool = False):
        """The microbatch this stage runs at each of the ``n_micro + S - 1``
        ticks where it is busy (the others are the bubble)."""
        ts = range(self.n_micro + self.n_stages - 1)
        for t in (reversed(ts) if reverse else ts):
            if 0 <= t - self.s < self.n_micro:
                yield t - self.s


class _Schedule(torch.autograd.Function):
    """The GPipe schedule over the stage group: microbatches ``xs``
    [n_micro, mb, ...] through this stage's layers ``params``; returns the
    last stage's outputs on every stage."""

    @staticmethod
    def forward(ctx, plan: _Plan, xs: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
        p = dict(zip(plan.names, params))
        last = plan.n_stages - 1
        outs = torch.empty_like(xs)
        kept = {}
        for m in plan.ticks():
            h = xs[m] if plan.s == 0 else plan.recv(xs[m], plan.s - 1)
            kept[m] = h
            h = plan.stage(p, h)
            if plan.s < last:
                plan.send(h, plan.s + 1)
            else:
                outs[m] = h
        ctx.plan, ctx.kept = plan, kept
        ctx.save_for_backward(*params)
        return plan.broadcast(outs, last)

    @staticmethod
    def backward(ctx, g_outs: torch.Tensor):
        plan, last = ctx.plan, ctx.plan.n_stages - 1
        params = ctx.saved_tensors
        need_x = ctx.needs_input_grad[1]
        leaves = [p.detach().requires_grad_(need) for p, need in zip(params, ctx.needs_input_grad[2:])]
        wanted = [p for p in leaves if p.requires_grad]
        grads = [torch.zeros_like(p) for p in wanted]
        dxs = torch.zeros_like(g_outs) if need_x else None
        for m in plan.ticks(reverse=True):
            g = g_outs[m] if plan.s == last else plan.recv(g_outs[m], plan.s + 1)
            with torch.enable_grad():
                h = ctx.kept[m].detach().requires_grad_(plan.s > 0 or need_x)
                out = plan.stage(dict(zip(plan.names, leaves)), h)
                inputs = ([h] if h.requires_grad else []) + wanted
                got = list(torch.autograd.grad(out, inputs, g, allow_unused=True)) if inputs else []
            if h.requires_grad:
                dh = got.pop(0)
                if plan.s > 0:
                    plan.send(dh, plan.s - 1)
                else:
                    dxs[m] = dh
            for acc, d in zip(grads, got):
                if d is not None:
                    acc.add_(d)
        if need_x:
            plan.broadcast(dxs, 0)
        it = iter(grads)
        return (None, dxs) + tuple(next(it) if p.requires_grad else None for p in leaves)


class _GatherMicro(torch.autograd.Function):
    """Every data rank's rows of each microbatch ([n_micro, mb/D, ...] ->
    [n_micro, mb, ...]); the backward keeps this rank's rows (the loss of
    the gathered batch is the same on every data rank)."""

    @staticmethod
    def forward(ctx, ys: torch.Tensor, mesh) -> torch.Tensor:
        ctx.rows = slice(mesh.data_rank * ys.shape[1], (mesh.data_rank + 1) * ys.shape[1])
        return all_gather_cat(ys.contiguous(), 1, mesh.data, mesh.data_group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g[:, ctx.rows], None


def _micro_rows(mesh, x: torch.Tensor, n_micro: int, has_data: bool) -> torch.Tensor:
    """``x`` [b, ...] as microbatches [n_micro, mb, ...], this data rank's
    rows of each (all of them without a data axis)."""
    xs = x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
    if not has_data:
        return xs
    k = xs.shape[1] // mesh.data
    return xs[:, mesh.data_rank * k:(mesh.data_rank + 1) * k]


def _run_stages(mesh, layer_fn: Callable, params: Mapping[str, torch.Tensor], xs: torch.Tensor, *,
               remat: bool = False) -> torch.Tensor:
    """The schedule on microbatches ``xs`` with this stage's layers
    ``params``: the last stage's outputs on every stage."""
    names = list(params)
    return _Schedule.apply(_Plan(mesh, layer_fn, names, xs.shape[0], remat), xs, *[params[n] for n in names])


def _gather_micro(mesh, ys: torch.Tensor, has_data: bool) -> torch.Tensor:
    return _GatherMicro.apply(ys, mesh) if has_data else ys


def pipeline_apply(mesh, layer_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   stacked_params: Mapping[str, torch.Tensor], x: torch.Tensor, *, n_micro: int,
                   data_axis: Optional[str] = DATA_AXIS, remat: bool = False) -> torch.Tensor:
    """Run ``layer_fn`` over all stacked layers, pipelined over the mesh
    ``stage`` axis: the same math as applying layers ``0..L-1`` in order to
    the global batch ``x`` [b, ...] (returned with ``x``'s shape, on every
    rank).

    ``layer_fn(layer_params, h) -> h`` applies ONE layer (shape-preserving);
    ``stacked_params`` ``{name: [L, ...]}`` (``stack_layer_params``), ``L``
    divisible by the stage count; ``b`` divisible by ``n_micro`` and, over a
    data axis, the microbatch by its extent. Differentiable: the backward
    is GPipe's (module docstring); ``remat`` checkpoints each layer inside
    the backward's recompute."""
    n_layers = next(iter(stacked_params.values())).shape[0]
    has_data = _check(mesh, n_layers, x.shape[0], n_micro, data_axis)
    k = n_layers // mesh.stage
    local = {n: v.narrow(0, mesh.stage_rank * k, k) for n, v in stacked_params.items()}
    ys = _run_stages(mesh, layer_fn, local, _micro_rows(mesh, x, n_micro, has_data), remat=remat)
    return _gather_micro(mesh, ys, has_data).reshape(x.shape)


def _sum_flat(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def pipeline_value_and_grad(mesh, layer_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                            stacked_params: Mapping[str, torch.Tensor], x: torch.Tensor,
                            loss_fn: Callable[[torch.Tensor], torch.Tensor], *, n_micro: int,
                            data_axis: Optional[str] = DATA_AXIS, remat: bool = True):
    """``(loss, grads)`` of ``loss_fn(pipeline_apply(...))``, the GPipe
    training backward: ``grads`` ``{name: [L, ...]}`` in the stacked layout,
    the whole gradient on every rank (each stage's layers' part, from each
    data rank's rows, summed over the stage and the data groups).
    ``loss_fn`` sees the global batch; the microbatches' gradients
    accumulate inside the schedule's backward."""
    names = list(stacked_params)
    leaves = {n: stacked_params[n].detach().requires_grad_() for n in names}
    has_data = _check(mesh, leaves[names[0]].shape[0], x.shape[0], n_micro, data_axis)
    loss = loss_fn(pipeline_apply(mesh, layer_fn, leaves, x, n_micro=n_micro, data_axis=data_axis, remat=remat))
    grads = list(torch.autograd.grad(loss, [leaves[n] for n in names]))
    grads = _sum_flat(grads, mesh.stage_group)
    if has_data:
        grads = _sum_flat(grads, mesh.data_group)
    return loss.detach(), dict(zip(names, grads))


def make_pipeline_train_step(mesh, layer_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                             loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], optimizer, *,
                             n_micro: int, data_axis: Optional[str] = DATA_AXIS, remat: bool = True):
    """One GPipe training step over the mesh ``stage`` axis.

    ``loss_fn(y, target) -> scalar``; ``optimizer``: a torch optimizer over
    this stage's layers, the tensors of ``stage_params(mesh, stacked)`` (the
    reference's optax transformation holds no params; a torch optimizer
    does, so each stage builds its own over its layers, and its state stays
    there). Returns ``step(params, x, target) -> loss``: ``params`` those
    tensors, updated in place by ``optimizer``; the gradients of a data
    rank's rows are summed over the data group before the update."""

    def step(params: Mapping[str, torch.Tensor], x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        n_layers = next(iter(params.values())).shape[0] * mesh.stage
        has_data = _check(mesh, n_layers, x.shape[0], n_micro, data_axis)
        optimizer.zero_grad(set_to_none=True)
        ys = _run_stages(mesh, layer_fn, params, _micro_rows(mesh, x, n_micro, has_data), remat=remat)
        loss = loss_fn(_gather_micro(mesh, ys, has_data).reshape(x.shape), target)
        loss.backward()
        held = [p for p in params.values() if p.grad is not None]
        if has_data and held:
            for p, g in zip(held, _sum_flat([p.grad for p in held], mesh.data_group)):
                p.grad = g
        optimizer.step()
        return loss.detach()

    return step


def vit_forward_pipelined(model, x: torch.Tensor, mesh, *, n_micro: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ViT classifier (``models/vit.py``) with its encoder-block trunk
    pipelined over the mesh ``stage`` axis: ``(cls_features, logits)`` of
    the global batch ``x`` [B, H, W, C], as ``model(x)`` gives them. The
    embedding and the head are whole on every rank and run on this data
    rank's rows of each microbatch; the features and logits are gathered over
    the data group (each rank's gradients are then its rows' share, to be
    summed over the data group, and a block's over the stage group too). The
    blocks must be dense (a MoE block stacks with another tree)."""
    from torch.func import functional_call

    has_data = _check(mesh, model.depth, x.shape[0], n_micro, DATA_AXIS)
    xs = _micro_rows(mesh, x, n_micro, has_data)
    n, mb = xs.shape[:2]
    h = model.embed(xs.reshape((n * mb,) + tuple(x.shape[1:])))
    stacked = stack_layer_params(dict(model.named_parameters()), "block", model.depth)
    k = model.depth // mesh.stage
    local = {name: v.narrow(0, mesh.stage_rank * k, k) for name, v in stacked.items()}
    template = model.block0

    def layer_fn(p: Params, tokens: torch.Tensor) -> torch.Tensor:
        return functional_call(template, p, (tokens,))

    h = _run_stages(mesh, layer_fn, local, h.reshape((n, mb) + tuple(h.shape[1:])))
    cls, logits = model.head_of(h.reshape((n * mb,) + tuple(h.shape[2:])))
    cls, logits = (_gather_micro(mesh, t.reshape((n, mb) + tuple(t.shape[1:])), has_data).reshape(
        (x.shape[0],) + tuple(t.shape[1:])) for t in (cls, logits))
    return cls, logits


__all__ = [
    "gather_stages",
    "make_pipeline_train_step",
    "pipeline_apply",
    "pipeline_value_and_grad",
    "stack_layer_params",
    "stage_params",
    "vit_forward_pipelined",
]
