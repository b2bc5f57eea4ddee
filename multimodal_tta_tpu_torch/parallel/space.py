"""The space axis: a volume's depth split over the ranks of a space group
(the counterpart of ``multimodal_tta_tpu/parallel/mesh.py:constrain_activations``).

In the reference the space axis is a set of layout pins, and XLA's
partitioner inserts the conv halo exchanges and the reductions. Here each
rank is a process, so the model calls the collectives itself, and a run
over ``space`` ranks computes what one process computes on whole volumes:

  * the layout rule (``splits``): a level of depth ``D`` is split while
    ``D % space == 0`` and every rank keeps at least 2 planes (the
    reference's rule); every other level is whole, gathered and computed
    alike on every space rank. A split level feeding a stride-2 conv holds
    an even slab whenever the level below it is split too; a conv whose
    output level is whole takes its input gathered (``gather_depth``);
  * ``halo_exchange`` gives a conv over a split depth its neighbours'
    boundary planes (zeros at the volume's two ends: SAME padding); its
    backward adds the halos' gradients into their owners' planes;
  * ``gather_depth`` (split -> whole): its backward all-reduces the
    gradient over the space group and keeps this rank's slab, so a whole
    level's gradient, which each rank takes only through its own slice of
    the next split level (``slice_depth``, a local slice), enters the
    world's gradient sum once;
  * ``space_sum`` sums per-sample partial sums over the space group:
    without a gradient (counts, statistics of the input), or with the sum's
    gradient (``grad=True``: the backward all-reduces the gradient), for a
    term that every rank computes alike from the global sums and divides
    by ``space`` (Dice's ratio, a global mean's share);
  * ``space_prefix`` gives each rank the exclusive prefix sum of a count
    over the earlier ranks (rank order is depth order) and the group's
    total: a split MoE's buffer positions (``models/moe.py``);
  * ``flip_depth`` mirrors the volume's depth: rank ``s`` takes rank
    ``S-1-s``'s slab, reversed (its backward is the same exchange);
    ``flip`` mirrors any dims, the depth over the group and the rest
    locally (flip TTA, CoTTA's and MEMO's mirrored views);
  * the transformers' tokens (``seq_shard_axis="space"``): a token axis of
    ``N`` splits over ``S`` ranks only when ``N % S == 0``
    (``tokens_split``, the reference's strict ``_maybe_shard_seq`` under
    the legacy ``with mesh:`` context), else it is whole on every rank;
    ``gather_depth`` on the token dim gathers a split token axis;
  * ``roll_depth`` rolls the volume's depth cyclically over the group
    (``torch.roll`` of the whole depth; its backward rolls back): the
    shifted windows of a Swin stage whose depth is split;
  * the 2D classifiers (ResNet, DenseNet, EfficientNet) split an NHWC
    image's height, its dim 1, which ``Mesh.local`` cuts as it cuts a
    volume's depth. Their convs and pools pad explicitly and
    symmetrically, so an op of kernel ``k``, stride ``s`` and pad ``p``
    takes ``row_halos(k, s, p)`` = ``(p, max(k - s - p, 0))`` rows from its
    neighbours (the stem's 7x7/2/3: (3, 2); a 3x3/2/1: (1, 0); a 1x1/2:
    none) and computes its slab of the whole op's output rows; a max-pool's
    halo holds -inf at the image's ends (``halo_exchange``'s ``fill``). A
    level stays split while the op that reads it keeps to the height rule
    (``rows_split``: a slab divisible by the stride, an output level that
    ``splits``, halos no wider than the slab); the first op that breaks it
    takes its input gathered (``row_axes`` plans the chain, ``relayout``
    gathers), and every level after it is whole on every space rank.

Every collective is an ``all_gather`` or an ``all_reduce`` over the space
group, which gloo and NCCL both take for CUDA tensors (gloo's ``send`` does
not, so the depth flip gathers the group's slabs too: at two ranks twice
the bytes of a pairwise swap, on input- and output-sized tensors).
``sharded(mesh)`` makes the mesh's space axis the ambient one for a model's
forward (``current``): the model computes each level's axis from it
(``level_axes``) at every forward and hands it to the level's blocks as an
argument, so no module keeps an axis; the loss, the intensity transform
and Tent get theirs as an argument too. ``ambient(None)`` runs a forward
whole inside a sharded block (a window whose depth does not split).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


class SpaceAxis:
    """This rank's place on the space axis of ``mesh``: ``size`` ranks,
    this one at ``rank``, their process ``group``."""

    def __init__(self, mesh):
        self.size = int(mesh.space)
        self.rank = int(mesh.space_rank)
        self.group = mesh.space_group

    def __repr__(self) -> str:
        return f"SpaceAxis(size={self.size}, rank={self.rank})"


# the ambient axes of the forwards running now, innermost last (as the
# reference's ambient_axes): a model reads the axis of the block it runs in
# without the mesh threaded through every module
_ACTIVE: List[Optional[SpaceAxis]] = []


def axis_of(mesh) -> Optional[SpaceAxis]:
    """The space axis of ``mesh`` (one object per mesh); None without one
    (or without a mesh)."""
    if mesh is None or getattr(mesh, "space", 1) <= 1:
        return None
    ax = getattr(mesh, "_space_axis", None)
    if ax is None:
        ax = mesh._space_axis = SpaceAxis(mesh)
    return ax


# the axis names of the meshes whose ``sharded`` blocks run now, innermost
# last: what the reference's ambient mesh carries (``mesh_axes``)
_MESHES: List[Tuple[str, ...]] = []


@contextmanager
def sharded(mesh):
    """The space axis of ``mesh`` is the ambient one inside the block (a
    model's forward reads it with ``current``), and ``mesh``'s axes are the
    ambient mesh's (``mesh_axes``); without a space axis the block runs as
    it is."""
    ax = axis_of(mesh)
    names = tuple(getattr(mesh, "shape", ())) if mesh is not None else None
    if names is not None:
        _MESHES.append(names)
    if ax is not None:
        _ACTIVE.append(ax)
    try:
        yield ax
    finally:
        if ax is not None:
            _ACTIVE.remove(ax)
        if names is not None:
            _MESHES.pop()


def mesh_axes() -> Tuple[str, ...]:
    """The axis names of the ambient mesh (the innermost ``sharded`` block's
    mesh: data and space, and each of model, expert and stage above 1, as
    the reference's mesh carries them); none outside every block."""
    return _MESHES[-1] if _MESHES else ()


@contextmanager
def ambient(ax: Optional[SpaceAxis]):
    """``ax`` is the ambient space axis inside the block; ``None`` makes a
    forward run whole there (every rank of the group alike), also inside
    ``sharded``."""
    _ACTIVE.append(ax)
    try:
        yield ax
    finally:
        _ACTIVE.pop()


def current() -> Optional[SpaceAxis]:
    return _ACTIVE[-1] if _ACTIVE else None


def splits(depth: int, size: int) -> bool:
    """Whether a level of ``depth`` planes is split over ``size`` ranks: the
    reference's ``constrain_activations`` rule."""
    return size > 1 and depth % size == 0 and depth // size >= 2


def level_axes(ax: Optional[SpaceAxis], depth: int, strides) -> List[Optional[SpaceAxis]]:
    """The axis of each level of a pyramid whose input holds ``depth`` local
    planes (the input level must be split) and whose levels follow by
    ``strides``: ``ax`` where the level is split, None where it is whole."""
    if ax is None:
        return [None] * (len(strides) + 1)
    d = depth * ax.size
    if not splits(d, ax.size):
        raise ValueError(f"[space] an input depth of {d} does not split over a space axis of {ax.size} "
                         f"(each rank needs at least 2 planes)")
    out = [ax]
    for s in strides:
        d = -(-d // int(s))
        out.append(ax if splits(d, ax.size) else None)
    return out


def row_halos(kernel: int, stride: int, pad: int) -> Tuple[int, int]:
    """The rows ``(lo, hi)`` that an op of ``kernel``, ``stride`` and
    symmetric ``pad`` over a split height takes from its left and right
    neighbours, so that a slab of ``n`` rows (``n % stride == 0``) gives
    its ``n // stride`` rows of the whole op's output."""
    return int(pad), max(int(kernel) - int(stride) - int(pad), 0)


def rows_split(n: int, ax: Optional[SpaceAxis], stride: int = 1, halo: int = 0) -> bool:
    """Whether an op of ``stride`` whose halos are at most ``halo`` rows runs
    on a split level whose slab holds ``n`` rows: the slab divides by the
    stride, the output level splits (``splits``: each rank at least 2
    rows) and the halos fit in a slab."""
    return ax is not None and n % stride == 0 and splits(n // stride * ax.size, ax.size) and halo <= n


def row_axes(ax: Optional[SpaceAxis], rows: int, ops) -> List[Optional[SpaceAxis]]:
    """The axis each op of a chain over a split height runs on (``ax``, or
    None: whole), for an input slab of ``rows`` rows and ``ops`` the
    ``(stride, halo)`` of each op in order: an input level that does not
    split, or the first op that breaks the height rule (``rows_split``),
    runs whole on every space rank, and so does every op after it."""
    if ax is not None and not splits(rows * ax.size, ax.size):
        ax = None
    out = []
    for stride, halo in ops:
        if ax is not None and not rows_split(rows, ax, stride, halo):
            ax = None
        out.append(ax)
        if ax is not None:
            rows //= stride
    return out


def tokens_split(n: int, size: int) -> bool:
    """Whether a token axis of ``n`` splits over ``size`` ranks: the
    reference's strict rule (``vit.py:_maybe_shard_seq``)."""
    return size > 1 and n % size == 0


# ---- collectives --------------------------------------------------------------


def _cl(t: torch.Tensor, dim: int):
    """``t`` with ``dim`` moved to 1 in a contiguous view (an NCDHW tensor in
    channels_last_3d memory is NDHWC underneath, an NCHW one in
    channels_last NHWC: a free permute), and the permutation back."""
    if t.dim() == 5 and dim == 2 and t.is_contiguous(memory_format=torch.channels_last_3d):
        return t.permute(0, 2, 3, 4, 1), (0, 4, 1, 2, 3), 1
    if t.dim() == 4 and dim == 2 and t.is_contiguous(memory_format=torch.channels_last):
        return t.permute(0, 2, 3, 1), (0, 3, 1, 2), 1
    return t.contiguous(), None, dim


def all_gather_cat(t: torch.Tensor, dim: int, size: int, group) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) of ``group`` concatenated on
    ``dim`` in rank order (no gradient)."""
    v, back, d = _cl(t, dim)
    parts = [torch.empty_like(v) for _ in range(size)]
    dist.all_gather(parts, v, group=group)
    out = torch.cat(parts, dim=d)
    return out.permute(*back) if back is not None else out


class _GatherDepth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax, ctx.local = dim, ax, x.shape[dim]
        return all_gather_cat(x, dim, ax.size, ax.group)

    @staticmethod
    def backward(ctx, g):
        v, back, d = _cl(g, ctx.dim)
        v = v.clone()
        dist.all_reduce(v, op=dist.ReduceOp.SUM, group=ctx.ax.group)
        v = v.narrow(d, ctx.ax.rank * ctx.local, ctx.local)
        return (v.permute(*back) if back is not None else v), None, None


def gather_depth(x: torch.Tensor, ax: SpaceAxis, dim: int = 2) -> torch.Tensor:
    """Split -> whole: the space group's slabs of ``x`` concatenated on
    ``dim``. Backward: the gradient all-reduced over the group, this rank's
    slab of it."""
    return _GatherDepth.apply(x, dim, ax)


def slice_depth(x: torch.Tensor, ax: SpaceAxis, dim: int = 2) -> torch.Tensor:
    """Whole -> split: this rank's slab of ``x`` on ``dim`` (a local slice;
    its backward is local too)."""
    k = x.shape[dim] // ax.size
    if k * ax.size != x.shape[dim]:
        raise ValueError(f"[space] a depth of {x.shape[dim]} does not split over {ax.size} ranks")
    return x.narrow(dim, ax.rank * k, k)


def relayout(t: torch.Tensor, have, want, ax: SpaceAxis, dim: int) -> torch.Tensor:
    """``t`` split over ``ax`` on ``dim`` (``have`` not None) or whole, as
    ``want`` asks: gathered (``gather_depth``), sliced (``slice_depth``), or
    as it is."""
    if (have is None) == (want is None):
        return t
    return gather_depth(t, ax, dim) if want is None else slice_depth(t, ax, dim)


def _exchange(x: torch.Tensor, dim: int, ax: SpaceAxis, first: int, last: int, fill: float = 0.0):
    """All-gather each rank's first ``first`` and last ``last`` planes of
    ``x`` on ``dim``; returns (the left neighbour's last ``last`` planes, the
    right neighbour's first ``first`` planes), ``fill`` past the volume's
    ends."""
    v, back, d = _cl(x, dim)
    n = v.shape[d]
    pieces = [v.narrow(d, 0, first), v.narrow(d, n - last, last)]
    buf = torch.cat(pieces, dim=d).contiguous()
    parts = [torch.empty_like(buf) for _ in range(ax.size)]
    dist.all_gather(parts, buf, group=ax.group)
    if ax.rank > 0:
        left = parts[ax.rank - 1].narrow(d, first, last)
    else:
        left = buf.new_full(buf.narrow(d, first, last).shape, fill)
    if ax.rank < ax.size - 1:
        right = parts[ax.rank + 1].narrow(d, 0, first)
    else:
        right = buf.new_full(buf.narrow(d, 0, first).shape, fill)
    if back is not None:
        left, right = left.permute(*back), right.permute(*back)
    return left, right


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, dim, ax, fill):
        ctx.lo, ctx.hi, ctx.dim, ctx.ax = lo, hi, dim, ax
        left, right = _exchange(x, dim, ax, hi, lo, fill)
        fmt = torch.contiguous_format
        if x.dim() == 5 and x.is_contiguous(memory_format=torch.channels_last_3d):
            fmt = torch.channels_last_3d
        elif x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
            fmt = torch.channels_last
        return torch.cat([left, x, right], dim=dim).contiguous(memory_format=fmt)

    @staticmethod
    def backward(ctx, g):
        lo, hi, dim, ax = ctx.lo, ctx.hi, ctx.dim, ctx.ax
        n = g.shape[dim] - lo - hi
        mid = g.narrow(dim, lo, n).clone()
        gl, gr = g.narrow(dim, 0, lo), g.narrow(dim, lo + n, hi)
        # the left halo's gradient belongs to the left neighbour's last lo
        # planes, the right halo's to the right neighbour's first hi planes
        both = torch.cat([gr, gl], dim=dim)  # each rank's [right halo | left halo] gradients
        v, back, d = _cl(both, dim)
        v = v.contiguous()
        parts = [torch.empty_like(v) for _ in range(ax.size)]
        dist.all_gather(parts, v, group=ax.group)
        if back is not None:
            parts = [p.permute(*back) for p in parts]
        if hi and ax.rank > 0:
            mid.narrow(dim, 0, hi).add_(parts[ax.rank - 1].narrow(dim, 0, hi))
        if lo and ax.rank < ax.size - 1:
            mid.narrow(dim, n - lo, lo).add_(parts[ax.rank + 1].narrow(dim, hi, lo))
        return mid, None, None, None, None, None


def halo_exchange(x: torch.Tensor, lo: int, hi: int, ax: SpaceAxis, dim: int = 2,
                  fill: float = 0.0) -> torch.Tensor:
    """``x`` with ``lo`` planes of the left neighbour before it and ``hi``
    planes of the right neighbour after it on ``dim`` (``fill`` at the
    volume's two ends: zeros, a conv's padding; -inf, a max-pool's).
    Backward: each halo's gradient is added into the planes of the rank
    that owns them."""
    n = x.shape[dim]
    if lo > n or hi > n:
        raise ValueError(f"[space] halos ({lo}, {hi}) wider than a slab of {n} planes")
    if lo == 0 and hi == 0:
        return x
    return _Halo.apply(x, lo, hi, dim, ax, float(fill))


class _SumWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ax.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.ax.group)
        return g, None


def space_sum(t: torch.Tensor, ax: Optional[SpaceAxis], grad: bool = False) -> torch.Tensor:
    """``t`` summed over the space group as a new tensor (``t`` itself
    without an axis). Without ``grad`` it carries no gradient; with it, the
    gradient of each rank's ``t`` is the sum of the ranks' upstream
    gradients, so a term that every rank computes alike from the sum and
    divides by the axis size enters the world's gradient sum once."""
    if ax is None:
        return t
    if grad:
        return _SumWithGrad.apply(t, ax)
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ax.group)
    return out


def _mirror(x: torch.Tensor, dim: int, ax: SpaceAxis) -> torch.Tensor:
    """Rank ``S-1-s``'s slab of ``x`` reversed on ``dim``, on rank ``s``."""
    v, back, d = _cl(x, dim)
    parts = [torch.empty_like(v) for _ in range(ax.size)]
    dist.all_gather(parts, v, group=ax.group)
    out = torch.flip(parts[ax.size - 1 - ax.rank], dims=(d,))
    return out.permute(*back) if back is not None else out


class _FlipDepth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _mirror(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        # a permutation that is its own inverse: the gradient takes the same way back
        return _mirror(g, ctx.dim, ctx.ax), None, None


def flip_depth(x: torch.Tensor, ax: SpaceAxis, dim: int = 1) -> torch.Tensor:
    """This rank's slab of the depth-mirrored volume whose slab ``x`` is
    (``dim``, NDHWC's 1 by default): rank ``s`` takes rank ``S-1-s``'s slab,
    reversed. Backward: the same exchange of the gradient."""
    return _FlipDepth.apply(x, dim, ax)


def flip(x: torch.Tensor, dims, ax: Optional[SpaceAxis] = None, depth_dim: int = 1) -> torch.Tensor:
    """``torch.flip(x, dims)`` of the whole volume that ``x`` is this rank's
    depth slab of (on ``depth_dim``): the depth mirrored over the space group
    (``flip_depth``), every other dim locally; ``torch.flip`` itself
    without an axis."""
    dims = tuple(int(d) for d in dims)
    if ax is None or depth_dim not in dims:
        return torch.flip(x, dims=dims)
    rest = tuple(d for d in dims if d != depth_dim)
    y = flip_depth(x, ax, depth_dim)
    return torch.flip(y, dims=rest) if rest else y


def _roll(x: torch.Tensor, shift: int, dim: int, ax: SpaceAxis) -> torch.Tensor:
    """This rank's slab of the whole depth rolled by ``shift`` planes
    (``torch.roll``: plane ``i`` takes plane ``i - shift``), ``|shift|`` at
    most a slab: a slab's planes that cross to the neighbour (cyclically)
    are all-gathered over the group."""
    v, back, d = _cl(x, dim)
    n, s = v.shape[d], abs(int(shift))
    if s > n:
        raise ValueError(f"[space] a roll by {shift} crosses more than a slab of {n} planes")
    if s == 0:
        return x
    piece = (v.narrow(d, n - s, s) if shift > 0 else v.narrow(d, 0, s)).contiguous()
    parts = [torch.empty_like(piece) for _ in range(ax.size)]
    dist.all_gather(parts, piece, group=ax.group)
    if shift > 0:  # the previous rank's last planes, then this slab's first
        out = torch.cat([parts[(ax.rank - 1) % ax.size], v.narrow(d, 0, n - s)], dim=d)
    else:  # this slab's last planes, then the next rank's first
        out = torch.cat([v.narrow(d, s, n - s), parts[(ax.rank + 1) % ax.size]], dim=d)
    return out.permute(*back) if back is not None else out


class _RollDepth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, dim, ax):
        ctx.shift, ctx.dim, ctx.ax = shift, dim, ax
        return _roll(x, shift, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _roll(g, -ctx.shift, ctx.dim, ctx.ax), None, None, None


def roll_depth(x: torch.Tensor, shift: int, ax: SpaceAxis, dim: int = 1) -> torch.Tensor:
    """This rank's slab of ``torch.roll(whole, shift, dims=dim)`` of the
    volume whose slab ``x`` is (``dim``, NDHWC's 1 by default), cyclically
    over the space group. Backward: the gradient rolled back."""
    return _RollDepth.apply(x, int(shift), dim, ax)


def space_size(ax: Optional[SpaceAxis]) -> int:
    return 1 if ax is None else ax.size


def space_prefix(t: torch.Tensor, ax: Optional[SpaceAxis]):
    """The exclusive prefix sum of ``t`` over the space group in rank order
    (rank order is depth order: the earlier ranks' part), and the group's
    total; no gradient. Without an axis: zeros and ``t``."""
    if ax is None:
        return torch.zeros_like(t), t
    parts = [torch.empty_like(t) for _ in range(ax.size)]
    dist.all_gather(parts, t.detach().contiguous(), group=ax.group)
    prefix = torch.zeros_like(t)
    for p in parts[:ax.rank]:
        prefix = prefix + p
    total = prefix.clone()
    for p in parts[ax.rank:]:
        total = total + p
    return prefix, total


__all__ = ["SpaceAxis", "axis_of", "sharded", "ambient", "current", "mesh_axes", "splits", "level_axes",
           "row_halos", "rows_split", "row_axes", "tokens_split", "all_gather_cat", "gather_depth", "slice_depth", "relayout",
           "halo_exchange", "flip_depth", "flip", "roll_depth", "space_sum", "space_size", "space_prefix"]
