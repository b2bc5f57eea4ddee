"""Fused InstanceNorm + affine + optional ReLU over NDHWC ``[B, D, H, W, C]``.

The port of ``multimodal_tta_tpu/pallas/fused_instance_norm.py``. On the
port it is the norm of every ``ConvBlock`` (``models/layers.py``), so it
carries the main path's forward and, under Tent, its backward.

* ``fused_instance_norm`` — the wrapper of the registered operators
  ``mtta::fused_instance_norm_forward`` and ``mtta::fused_instance_norm_backward``
  (``torch.library.custom_op``; the forward's autograd calls the backward
  operator). For a CUDA tensor both launch a hand-written kernel of
  ``csrc/fused_instance_norm.cu`` (built by ``nvcc`` at first use,
  ``_build.py``) with one host call each, or raise; a CPU tensor takes the
  plain versions; any other device raises. No other route exists, in eager
  code or in a traced program that holds the operators: there is no
  fallback from a failed build or launch. ``fused_instance_norm.launches``
  counts forward launches, ``fused_instance_norm.backward_launches`` backward
  launches, both inside the CUDA implementations, so that launches from a
  traced program count too.
  ``instance_norm_forward`` and ``instance_norm_backward`` are the two
  halves without autograd, with the same routing.
* ``plan`` — picks the kernel's regime and launch geometry from the shape
  and the card's properties: a pure function of integers.
* ``instance_norm_plain`` / ``instance_norm_backward_plain`` — the plain
  PyTorch versions of the same two functions: what the CPU tests run, and
  what the kernels are held against on the card.
  ``instance_norm_backward_plain.cuda_calls`` counts its calls on CUDA
  tensors, which the main path must never make.

The forward saves x, gamma, beta and the f32 ``[2, B, C]`` mean/rstd, not y:
the backward recomputes the ReLU mask ``xhat * gamma + beta > 0`` from x with
the forward's exact arithmetic, which costs no read of y.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

_REDUCE = (1, 2, 3)  # D, H, W of NDHWC
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

THREADS = 256  # threads per CTA of every kernel in the source
ROW_BYTES = 32  # a resident slice row: one memory sector, two 16-byte vectors
CLUSTER_SIZES = (1, 2, 4, 8)  # 8 is the portable limit of a cluster
# bytes of a resident slice a CTA takes before the slice is spread over a
# larger cluster: the call is latency-bound, so more CTAs with less each
RESIDENT_TARGET_BYTES = 16 * 1024
# static shared memory of the resident kernels (warp and CTA partials), rounded up
RESIDENT_STATIC_BYTES = 2048
# streaming: CTAs per SM to ask for at most (1024 threads with 16-byte loads
# in flight saturate the memory system; more CTAs only mean more partials)
STREAM_CTAS_PER_SM = 4
_MIN_ROWS_PER_THREAD = 4


def _check_act(act: Optional[str]) -> bool:
    if act not in (None, "relu"):
        raise ValueError(f"fused_instance_norm: act must be None or 'relu', got {act!r}")
    return act == "relu"


# ---- plain versions ---------------------------------------------------------


def _plain_forward(x, gamma, beta, eps: float, relu: bool):
    """The model's norm arithmetic (JAX ``models/layers.py:73-82``): f32
    statistics, ``var = max(E[x^2] - E[x]^2, 0)``, output in x's dtype.
    Returns (y, mean [B, C], rstd [B, C])."""
    xf = x.float()
    mean = xf.mean(dim=_REDUCE)
    mean2 = xf.square().mean(dim=_REDUCE)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + eps)
    shp = (x.shape[0], 1, 1, 1, x.shape[-1])
    y = (xf - mean.view(shp)) * rstd.view(shp) * gamma + beta
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), mean, rstd


def instance_norm_plain(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-5,
    act: Optional[str] = "relu",
) -> torch.Tensor:
    """Plain PyTorch version of ``fused_instance_norm`` (differentiable by
    autograd), on any device."""
    return _plain_forward(x, gamma, beta, eps, _check_act(act))[0]


def instance_norm_backward_plain(gy, x, gamma, beta, mean, rstd, relu: bool, need_dx: bool = True):
    """Plain PyTorch version of the backward kernel, on any device. ``mean``
    and ``rstd`` are the forward's f32 ``[B, C]`` statistics. Returns
    ``(dx or None, dgamma, dbeta)``; dx in x's dtype, the others f32 ``[C]``."""
    if gy.is_cuda:
        instance_norm_backward_plain.cuda_calls += 1
    shp = (x.shape[0], 1, 1, 1, x.shape[-1])
    mean, rstd = mean.view(shp), rstd.view(shp)
    xhat = (x.float() - mean) * rstd
    g = gy.float()
    if relu:
        g = g * (xhat * gamma + beta > 0)
    dgamma = (g * xhat).sum(dim=(0,) + _REDUCE)
    dbeta = g.sum(dim=(0,) + _REDUCE)
    dx = None
    if need_dx:
        # d/dx of (x - mean) * rsqrt(var + eps) with var = E[x^2] - E[x]^2;
        # the clamp at 0 only binds for constant channels, where xhat = 0
        dxhat = g * gamma
        dx = rstd * (
            dxhat
            - dxhat.mean(dim=_REDUCE, keepdim=True)
            - xhat * (dxhat * xhat).mean(dim=_REDUCE, keepdim=True)
        )
        dx = dx.to(x.dtype)
    return dx, dgamma, dbeta


instance_norm_backward_plain.cuda_calls = 0


# ---- the launch plan --------------------------------------------------------


@dataclass(frozen=True)
class Plan:
    """How one call runs on the card (see the note in the CUDA source)."""

    regime: str  # "resident" or "streaming"
    vec: int  # elements per load: 16 bytes' worth, or 1 on the scalar path
    cg: int  # resident: channels per group (32 bytes); streaming: 0
    cluster: int  # resident: CTAs per cluster, sharing one slice; streaming: 1
    rows: int  # rows per CTA (resident) or per chunk (streaming)
    chunks: int  # row chunks per sample: the cluster size, or P
    grid: Tuple[int, ...]  # (cluster, C // cg, B) or (CTAs,)
    smem_bytes: int  # dynamic shared memory per CTA
    ws_floats: int  # f32 workspace for the partials [B, P, 2, C]; resident: 0
    hbm_reads: int  # times the inputs come from HBM: 2 only when they exceed the L2

    @property
    def ctas(self) -> int:
        n = 1
        for g in self.grid:
            n *= g
        return n


def plan(B: int, S: int, C: int, itemsize: int, smem_optin: int, sms: int, l2_bytes: int, *,
         arrays: int = 1, ctas_per_sm: int = STREAM_CTAS_PER_SM, aligned: bool = True) -> Plan:
    """Pick regime and geometry for x ``[B, S, C]`` of ``itemsize`` bytes.

    ``smem_optin``: shared memory one block may opt in to; ``sms``: SM count;
    ``l2_bytes``: L2 size; ``arrays``: tensors a CTA must hold per slice (1
    forward: x; 2 backward: gy and x); ``ctas_per_sm``: co-resident CTAs of
    the streaming kernel per SM; ``aligned``: every pointer is 16-byte
    aligned. Raises ``ValueError`` for a shape no regime can launch."""
    if min(B, S, C) <= 0:
        raise ValueError(f"fused_instance_norm: empty input B={B} S={S} C={C}")
    if itemsize not in (2, 4) or arrays not in (1, 2) or ctas_per_sm < 1 or sms < 1:
        raise ValueError("fused_instance_norm: plan() got an unsupported itemsize/arrays/occupancy")
    full = 16 // itemsize
    vec = full if aligned and C % full == 0 else 1
    cg = ROW_BYTES // itemsize
    hbm_reads = 1 if arrays * B * S * C * itemsize <= l2_bytes else 2

    if vec == full and C % cg == 0 and B <= 65535 and C // cg <= 65535:
        limit = smem_optin - RESIDENT_STATIC_BYTES
        fits = [(k, -(-S // k)) for k in CLUSTER_SIZES if -(-S // k) * ROW_BYTES * arrays <= limit]
        if fits:
            small = [kr for kr in fits if kr[1] * ROW_BYTES * arrays <= RESIDENT_TARGET_BYTES]
            cluster, rows = small[0] if small else fits[-1]
            return Plan("resident", vec, cg, cluster, rows, cluster, (cluster, C // cg, B),
                        rows * ROW_BYTES * arrays, 0, 1)

    return stream_plan(B, S, C, vec, smem_optin, sms, ctas_per_sm, hbm_reads)


def stream_plan(B: int, S: int, C: int, vec: int, smem_optin: int, sms: int, ctas_per_sm: int,
                hbm_reads: int = 1) -> Plan:
    """The streaming regime's geometry: ``vec`` elements a load, as many
    chunks per sample as the co-resident grid of ``ctas_per_sm`` CTAs per SM
    takes. The split entries always run in it."""
    smem = (THREADS * 2 * vec + 2 * C) * 4
    if smem > smem_optin:
        raise ValueError(f"fused_instance_norm: C={C} needs {smem} bytes of shared memory, "
                         f"the card allows {smem_optin}")
    coresident = ctas_per_sm * sms
    rows_per_iter = THREADS // min(C // vec, THREADS)
    chunks = max(1, min(coresident // B, -(-S // (_MIN_ROWS_PER_THREAD * rows_per_iter))))
    rows = -(-S // chunks)
    chunks = -(-S // rows)
    return Plan("streaming", vec, 0, 1, rows, chunks, (min(coresident, B * chunks),),
                smem, B * chunks * 2 * C, hbm_reads)


def plan_chunks(p: Plan, B: int, S: int, C: int) -> Iterator[Tuple[int, int, int, int, int]]:
    """Every piece of work of a plan as ``(b, c_start, c_stop, row_start,
    row_stop)``: one per CTA (resident) or per chunk (streaming). Together
    they cover each (b, c, row) exactly once."""
    for b in range(B):
        for c0 in (range(0, C, p.cg) if p.regime == "resident" else (0,)):
            c1 = c0 + p.cg if p.regime == "resident" else C
            for k in range(p.chunks):
                r0 = k * p.rows
                if r0 < S:
                    yield b, c0, c1, r0, min(S, r0 + p.rows)


# ---- the kernels' binding ---------------------------------------------------

_REGIME_CODE = {"resident": 0, "streaming": 1}


class _Cached:
    """A plan as the launcher takes it, kept per (device, shape, dtype,
    direction, alignment) so that a call costs one dictionary lookup."""

    __slots__ = ("plan", "tail", "validated")

    def __init__(self, p: Plan):
        self.plan = p
        # the launcher's arguments from `regime` to `smem`
        self.tail = (_REGIME_CODE[p.regime], p.vec, p.cluster, p.rows, p.grid[0], p.chunks,
                     p.smem_bytes)
        self.validated = False  # the launcher's occupancy checks have passed once


_plans: Dict[tuple, _Cached] = {}
# One f32 workspace per (device, stream) for the streaming regime's partials.
# Reuse across calls is safe because launches on one stream run in order: the
# next kernel that writes the workspace starts only after the one before it
# has read its partials.
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


_lib = None


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("fused_instance_norm").lib
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mtta_instance_norm_forward.argtypes = (
            [p] * 6 + [i] * 5 + [ctypes.c_float] + [i] * 6 + [ll, i, p])
        lib.mtta_instance_norm_forward.restype = i
        lib.mtta_instance_norm_backward.argtypes = [p] * 8 + [i] * 12 + [ll, i, p]
        lib.mtta_instance_norm_backward.restype = i
        lib.mtta_instance_norm_stream_ctas_per_sm.argtypes = [i, i, i, ll]
        lib.mtta_instance_norm_stream_ctas_per_sm.restype = i
        lib.mtta_instance_norm_stats.argtypes = [p] * 3 + [i] * 8 + [ll, i, p]
        lib.mtta_instance_norm_stats.restype = i
        f = ctypes.c_float
        lib.mtta_instance_norm_apply.argtypes = [p] * 6 + [i] * 5 + [f, f] + [i] * 4 + [p]
        lib.mtta_instance_norm_apply.restype = i
        lib.mtta_instance_norm_bwd_sums.argtypes = [p] * 7 + [i] * 9 + [ll, i, p]
        lib.mtta_instance_norm_bwd_sums.restype = i
        lib.mtta_instance_norm_bwd_apply.argtypes = [p] * 7 + [i] * 5 + [f] + [i] * 4 + [p]
        lib.mtta_instance_norm_bwd_apply.restype = i
        lib.mtta_instance_norm_split_ctas_per_sm.argtypes = [i, i, i, ll]
        lib.mtta_instance_norm_split_ctas_per_sm.restype = i
        lib.mtta_cuda_error_string.argtypes = [i]
        lib.mtta_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _cached_plan(x: torch.Tensor, others, backward: bool) -> _Cached:
    B, C = x.shape[0], x.shape[-1]
    aligned = x.data_ptr() % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in others)
    key = (x.device.index, B, x.numel(), C, x.dtype, backward, aligned)
    got = _plans.get(key)
    if got is not None:
        return got
    S = x.numel() // (B * C)
    props = torch.cuda.get_device_properties(x.device)
    smem_optin = props.shared_memory_per_block_optin
    full = 16 // x.element_size()
    vec = full if aligned and C % full == 0 else 1
    with torch.cuda.device(x.device):
        per_sm = _library().mtta_instance_norm_stream_ctas_per_sm(
            int(backward), int(x.dtype == torch.bfloat16), vec,
            min((THREADS * 2 * vec + 2 * C) * 4, smem_optin))
    if per_sm < 1:
        raise RuntimeError(f"fused_instance_norm: the streaming kernel does not fit an SM for "
                           f"x {tuple(x.shape)} (occupancy query returned {per_sm})")
    got = _Cached(plan(B, S, C, x.element_size(), smem_optin, props.multi_processor_count,
                       props.L2_cache_size, arrays=2 if backward else 1,
                       ctas_per_sm=min(per_sm, STREAM_CTAS_PER_SM), aligned=aligned))
    _plans[key] = got
    return got


def plan_for(x: torch.Tensor, *others: torch.Tensor, backward: bool = False) -> Plan:
    """The plan the wrapper uses for CUDA tensor ``x`` (and the other tensors
    of its shape that the kernel reads or writes) on x's device."""
    return _cached_plan(x, others, backward).plan


def _launch(fn, what: str, x: torch.Tensor, entry: _Cached, pointers: tuple, sizes: tuple) -> None:
    """Call launcher ``fn`` with the tensors' pointers, the workspace, the
    sizes and flags and the plan's arguments, on x's device and the current
    stream; raise if the launch is refused."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch(fn, what, x, entry, pointers, sizes)
    p = entry.plan
    # the current stream's handle as an int, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    ws = None
    if p.ws_floats:
        ws = _workspaces.get((x.device.index, stream))
        if ws is None or ws.numel() < p.ws_floats:
            ws = torch.empty(p.ws_floats, device=x.device, dtype=torch.float32)
            _workspaces[(x.device.index, stream)] = ws
        ws = ws.data_ptr()
    code = fn(*pointers, ws, *sizes, *entry.tail, int(not entry.validated), stream)
    if code != 0:
        text = _library().mtta_cuda_error_string(code).decode()
        raise RuntimeError(f"fused_instance_norm: {what} launch refused for x {tuple(x.shape)} "
                           f"with {p}: CUDA error {code} ({text})")
    entry.validated = True


def _check_x(x) -> Tuple[int, int, int]:
    if x.dim() != 5:
        raise ValueError(f"fused_instance_norm: x must be [B,D,H,W,C], got {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused_instance_norm: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_instance_norm: x must be contiguous NDHWC")
    B, D, H, W, C = x.shape
    S = D * H * W
    if S == 0 or B == 0 or C == 0:
        raise ValueError(f"fused_instance_norm: empty input {tuple(x.shape)}")
    if S * C >= 2**31:
        raise ValueError("fused_instance_norm: one sample must hold fewer than 2**31 elements")
    return B, S, C


def _check_inputs(x, gamma, beta) -> Tuple[int, int, int]:
    B, S, C = _check_x(x)
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (C,) or t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"fused_instance_norm: {name} must be a contiguous f32 [{C}] tensor on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    return B, S, C


def _check_gy(gy: torch.Tensor, x: torch.Tensor) -> None:
    if gy.shape != x.shape or gy.dtype != x.dtype or gy.device != x.device or not gy.is_contiguous():
        raise ValueError(f"fused_instance_norm: the output's gradient must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)} tensor on {x.device}, got {gy.dtype} {tuple(gy.shape)} on {gy.device}")


def _check_sums(t: torch.Tensor, x: torch.Tensor, name: str) -> None:
    B, C = x.shape[0], x.shape[-1]
    if t.shape != (2, B, C) or t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
        raise ValueError(f"fused_instance_norm: {name} must be a contiguous f32 [2, {B}, {C}] tensor on "
                         f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch_forward(x, gamma, beta, eps: float, relu: bool):
    """Run the forward kernel on CUDA tensors; returns (y, stats [2, B, C])
    with stats[0] = mean and stats[1] = rstd."""
    B, S, C = _check_inputs(x, gamma, beta)
    y = torch.empty_like(x)
    stats = torch.empty((2, B, C), device=x.device, dtype=torch.float32)
    _launch(_library().mtta_instance_norm_forward, "forward", x, _cached_plan(x, (y,), False),
            (x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), stats.data_ptr()),
            (B, S, C, int(x.dtype == torch.bfloat16), int(relu), eps))
    fused_instance_norm.launches += 1
    return y, stats


def _launch_backward(gy, x, gamma, beta, stats, relu: bool, need_dx: bool):
    """Run the backward kernel; returns (dx or None, sums [2, B, C]) with
    sums[0] = sum g and sums[1] = sum g * xhat per sample."""
    B, S, C = _check_inputs(x, gamma, beta)
    _check_gy(gy, x)
    _check_sums(stats, x, "stats")
    dx = torch.empty_like(x) if need_dx else None
    sums = torch.empty((2, B, C), device=x.device, dtype=torch.float32)
    entry = _cached_plan(x, (gy, dx) if need_dx else (gy,), True)
    _launch(_library().mtta_instance_norm_backward, "backward", x, entry,
            (gy.data_ptr(), x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), stats.data_ptr(),
             dx.data_ptr() if need_dx else None, sums.data_ptr()),
            (B, S, C, int(x.dtype == torch.bfloat16), int(relu), int(need_dx)))
    fused_instance_norm.backward_launches += 1
    return dx, sums


# ---- the operators ----------------------------------------------------------
# Both halves are registered torch operators, the only route to the kernels:
# a traced program (torch.export, ``serving/export.py``) holds them as calls
# that it replays, and eager code calls the same operators. The CPU
# implementation is the plain version and the CUDA one the kernel launch; no
# other device has one (a fake implementation gives the shapes to tracers).
# An operator's outputs may not alias each other, so the backward returns
# ``x.new_empty(0)`` for a dx it was not asked for.


@torch.library.custom_op("mtta::fused_instance_norm_forward", mutates_args=(), device_types="cpu")
def _forward_op(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                relu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    y, mean, rstd = _plain_forward(x, gamma, beta, eps, relu)
    return y, torch.stack((mean, rstd))


@_forward_op.register_kernel("cuda")
def _forward_cuda(x, gamma, beta, eps, relu):
    return _launch_forward(x, gamma, beta, eps, relu)


@_forward_op.register_fake
def _forward_fake(x, gamma, beta, eps, relu):
    stats = x.new_empty((2, x.shape[0], x.shape[-1]), dtype=torch.float32)
    return torch.empty_like(x, memory_format=torch.contiguous_format), stats


@torch.library.custom_op("mtta::fused_instance_norm_backward", mutates_args=(), device_types="cpu")
def _backward_op(gy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 stats: torch.Tensor, relu: bool, need_dx: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dx, dgamma, dbeta = instance_norm_backward_plain(gy, x, gamma, beta, stats[0], stats[1], relu, need_dx)
    return (dx if need_dx else x.new_empty(0)), dgamma, dbeta


@_backward_op.register_kernel("cuda")
def _backward_cuda(gy, x, gamma, beta, stats, relu, need_dx):
    dx, sums = _launch_backward(gy, x, gamma, beta, stats, relu, need_dx)
    # over the samples; two sums, as the outputs may not be views of one
    return (dx if need_dx else x.new_empty(0)), sums[1].sum(dim=0), sums[0].sum(dim=0)


@_backward_op.register_fake
def _backward_fake(gy, x, gamma, beta, stats, relu, need_dx):
    dx = torch.empty_like(x, memory_format=torch.contiguous_format) if need_dx else x.new_empty(0)
    return dx, gamma.new_empty(gamma.shape), gamma.new_empty(gamma.shape)


def _setup_context(ctx, inputs, output):
    x, gamma, beta, _, relu = inputs
    ctx.relu = relu
    ctx.set_materialize_grads(False)
    ctx.mark_non_differentiable(output[1])
    ctx.save_for_backward(x, gamma, beta, output[1])


def _backward(ctx, gy, _gstats):
    if gy is None:
        return None, None, None, None, None
    x, gamma, beta, stats = ctx.saved_tensors
    need_dx, need_gamma, need_beta = ctx.needs_input_grad[:3]
    # the first norm's input needs no dx: its kernel then writes none
    dx, dgamma, dbeta = _backward_op(gy.contiguous(), x, gamma, beta, stats, ctx.relu, need_dx)
    return (dx if need_dx else None, dgamma if need_gamma else None,
            dbeta if need_beta else None, None, None)


_forward_op.register_autograd(_backward, setup_context=_setup_context)


def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_instance_norm: no kernel for device {x.device}")


def instance_norm_forward(x, gamma, beta, *, eps: float = 1e-5, relu: bool = True):
    """The forward without autograd: ``(y, stats)`` with the f32 statistics
    ``stats`` ``[2, B, C]`` (mean, rstd) that ``instance_norm_backward`` takes.
    A CUDA tensor launches the forward kernel or raises; a CPU tensor takes
    the plain version."""
    _check_device(x)
    with torch.no_grad():
        return _forward_op(x, gamma, beta, float(eps), bool(relu))


def instance_norm_backward(gy, x, gamma, beta, stats, *, relu: bool, need_dx: bool = True):
    """The gradient of ``fused_instance_norm`` at output gradient ``gy``, from
    the forward's input and its f32 ``stats`` ``[2, B, C]`` (mean, rstd):
    ``(dx or None, dgamma, dbeta)``. A CUDA tensor launches the backward
    kernel or raises; a CPU tensor takes the plain version."""
    _check_device(x)
    dx, dgamma, dbeta = _backward_op(gy.contiguous(), x, gamma, beta, stats, bool(relu), bool(need_dx))
    return (dx if need_dx else None), dgamma, dbeta


def fused_instance_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-5,
    act: Optional[str] = "relu",
) -> torch.Tensor:
    """InstanceNorm over the spatial dims of NDHWC ``x`` ([B, D, H, W, C]),
    with the affine transform and optional ReLU fused: returns
    ``act((x - mean) * rsqrt(var + eps) * gamma + beta)`` in x's dtype, with
    mean/var per (B, C) taken in f32. Differentiable in x, gamma and beta
    (the backward operator). Launches on the current stream and does not
    synchronise."""
    relu = _check_act(act)
    _check_device(x)
    return _forward_op(x, gamma, beta, float(eps), relu)[0]


fused_instance_norm.launches = 0
fused_instance_norm.backward_launches = 0


# ---- the split-depth entries ------------------------------------------------
# Over a depth split between ranks (``parallel/space.py``) the per-(b, c)
# statistics span ranks, so the norm runs as two halves with an all-reduce
# between them, as the TPU kernel's two ``pallas_call``s do within one
# device: ``stats`` (this slab's f32 sums of x and x^2), then ``apply``
# (normalise with the global sums); backward ``bwd_sums`` (this slab's
# sums of g and g * xhat), then ``bwd_apply`` (dx from the global sums).
# Each is a registered operator with a plain version for the CPU and a
# kernel of ``csrc/fused_instance_norm.cu`` for CUDA (no other route); each
# counts its CUDA launches in ``<wrapper>.launches``. ``n`` is a (b, c)'s
# element count over the whole depth.


def instance_norm_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``stats``: f32 ``[2, B, C]``, sum x and sum x^2 over
    D, H, W."""
    xf = x.float()
    return torch.stack((xf.sum(dim=_REDUCE), xf.square().sum(dim=_REDUCE)))


def _finish_plain(sums: torch.Tensor, n: float, eps: float):
    mean = sums[0] / n
    var = torch.clamp(sums[1] / n - mean.square(), min=0.0)
    return mean, torch.rsqrt(var + eps)


def instance_norm_apply_plain(x, gamma, beta, sums, n: float, eps: float, relu: bool):
    """Plain version of ``apply``: ``(y, stats)``, the statistics from the
    global sums as the one-launch kernel forms them (``var = max(E[x^2] -
    E[x]^2, 0)``), ``stats`` [2, B, C] = (mean, rstd)."""
    mean, rstd = _finish_plain(sums, n, eps)
    shp = (x.shape[0], 1, 1, 1, x.shape[-1])
    y = (x.float() - mean.view(shp)) * rstd.view(shp) * gamma + beta
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), torch.stack((mean, rstd))


def _masked_grad(gy, x, gamma, beta, stats, relu: bool):
    shp = (x.shape[0], 1, 1, 1, x.shape[-1])
    xhat = (x.float() - stats[0].view(shp)) * stats[1].view(shp)
    g = gy.float()
    if relu:
        g = g * (xhat * gamma + beta > 0)
    return g, xhat


def instance_norm_bwd_sums_plain(gy, x, gamma, beta, stats, relu: bool) -> torch.Tensor:
    """Plain version of ``bwd_sums``: f32 ``[2, B, C]``, sum g and sum g *
    xhat over this slab (g the output gradient through the ReLU mask)."""
    g, xhat = _masked_grad(gy, x, gamma, beta, stats, relu)
    return torch.stack((g.sum(dim=_REDUCE), (g * xhat).sum(dim=_REDUCE)))


def instance_norm_bwd_apply_plain(gy, x, gamma, beta, stats, sums, n: float, relu: bool) -> torch.Tensor:
    """Plain version of ``bwd_apply``: ``dx = rstd * gamma * (g - sum g / n -
    xhat * sum g xhat / n)`` from the global sums, in x's dtype."""
    g, xhat = _masked_grad(gy, x, gamma, beta, stats, relu)
    shp = (x.shape[0], 1, 1, 1, x.shape[-1])
    dx = stats[1].view(shp) * gamma * (g - (sums[0] / n).view(shp) - xhat * (sums[1] / n).view(shp))
    return dx.to(x.dtype)


_split_plans: Dict[tuple, Plan] = {}


def split_plan_for(x: torch.Tensor, *others: torch.Tensor, backward: bool = False) -> Plan:
    """The streaming geometry of the split entries for CUDA tensor ``x`` (the
    cooperative ``stats`` / ``bwd_sums`` sets how many CTAs co-reside)."""
    B, C = x.shape[0], x.shape[-1]
    aligned = x.data_ptr() % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in others)
    key = (x.device.index, B, x.numel(), C, x.dtype, backward, aligned)
    got = _split_plans.get(key)
    if got is not None:
        return got
    S = x.numel() // (B * C)
    props = torch.cuda.get_device_properties(x.device)
    full = 16 // x.element_size()
    vec = full if aligned and C % full == 0 else 1
    smem = (THREADS * 2 * vec + 2 * C) * 4
    with torch.cuda.device(x.device):
        per_sm = _library().mtta_instance_norm_split_ctas_per_sm(
            int(backward), int(x.dtype == torch.bfloat16), vec, min(smem, props.shared_memory_per_block_optin))
    if per_sm < 1:
        raise RuntimeError(f"fused_instance_norm: the split kernel does not fit an SM for x {tuple(x.shape)} "
                           f"(occupancy query returned {per_sm})")
    got = stream_plan(B, S, C, vec, props.shared_memory_per_block_optin, props.multi_processor_count,
                      min(per_sm, STREAM_CTAS_PER_SM))
    _split_plans[key] = got
    return got


def _split_call(fn, what: str, x: torch.Tensor, p: Plan, args: tuple) -> None:
    """Call split launcher ``fn(*args, stream)`` on x's device and current
    stream; raise if the launch is refused."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _split_call(fn, what, x, p, args)
    code = fn(*args, torch._C._cuda_getCurrentRawStream(x.device.index))
    if code != 0:
        text = _library().mtta_cuda_error_string(code).decode()
        raise RuntimeError(f"fused_instance_norm: {what} launch refused for x {tuple(x.shape)} with {p}: "
                           f"CUDA error {code} ({text})")


def _split_workspace(x: torch.Tensor, p: Plan) -> int:
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    ws = _workspaces.get((x.device.index, stream))
    if ws is None or ws.numel() < p.ws_floats:
        ws = torch.empty(p.ws_floats, device=x.device, dtype=torch.float32)
        _workspaces[(x.device.index, stream)] = ws
    return ws.data_ptr()


def _geometry(x) -> tuple:
    B, S, C = x.shape[0], x.numel() // (x.shape[0] * x.shape[-1]), x.shape[-1]
    return B, S, C, int(x.dtype == torch.bfloat16)


@torch.library.custom_op("mtta::instance_norm_stats", mutates_args=(), device_types="cpu")
def _stats_op(x: torch.Tensor) -> torch.Tensor:
    return instance_norm_stats_plain(x)


@_stats_op.register_kernel("cuda")
def _stats_cuda(x):
    _check_x(x)
    p = split_plan_for(x)
    B, S, C, bf16 = _geometry(x)
    out = torch.empty((2, B, C), device=x.device, dtype=torch.float32)
    _split_call(_library().mtta_instance_norm_stats, "stats", x, p,
                (x.data_ptr(), out.data_ptr(), _split_workspace(x, p), B, S, C, bf16, p.vec, p.rows, p.grid[0],
                 p.chunks, p.smem_bytes, 1))
    instance_norm_stats.launches += 1
    return out


@_stats_op.register_fake
def _stats_fake(x):
    return x.new_empty((2, x.shape[0], x.shape[-1]), dtype=torch.float32)


@torch.library.custom_op("mtta::instance_norm_apply", mutates_args=(), device_types="cpu")
def _apply_op(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, sums: torch.Tensor, n: float,
              eps: float, relu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return instance_norm_apply_plain(x, gamma, beta, sums, n, eps, relu)


@_apply_op.register_kernel("cuda")
def _apply_cuda(x, gamma, beta, sums, n, eps, relu):
    _check_inputs(x, gamma, beta)
    _check_sums(sums, x, "sums")
    y = torch.empty_like(x)
    p = split_plan_for(x, y)
    B, S, C, bf16 = _geometry(x)
    stats = torch.empty((2, B, C), device=x.device, dtype=torch.float32)
    _split_call(_library().mtta_instance_norm_apply, "apply", x, p,
                (x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), sums.data_ptr(), stats.data_ptr(),
                 B, S, C, bf16, int(relu), float(n), float(eps), p.vec, p.rows, p.grid[0], p.chunks))
    instance_norm_apply.launches += 1
    return y, stats


@_apply_op.register_fake
def _apply_fake(x, gamma, beta, sums, n, eps, relu):
    return torch.empty_like(x, memory_format=torch.contiguous_format), sums.new_empty(sums.shape)


@torch.library.custom_op("mtta::instance_norm_bwd_sums", mutates_args=(), device_types="cpu")
def _bwd_sums_op(gy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 stats: torch.Tensor, relu: bool) -> torch.Tensor:
    return instance_norm_bwd_sums_plain(gy, x, gamma, beta, stats, relu)


@_bwd_sums_op.register_kernel("cuda")
def _bwd_sums_cuda(gy, x, gamma, beta, stats, relu):
    _check_inputs(x, gamma, beta)
    _check_gy(gy, x)
    _check_sums(stats, x, "stats")
    p = split_plan_for(x, gy, backward=True)
    B, S, C, bf16 = _geometry(x)
    out = torch.empty((2, B, C), device=x.device, dtype=torch.float32)
    _split_call(_library().mtta_instance_norm_bwd_sums, "bwd_sums", x, p,
                (gy.data_ptr(), x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), stats.data_ptr(), out.data_ptr(),
                 _split_workspace(x, p), B, S, C, bf16, int(relu), p.vec, p.rows, p.grid[0], p.chunks,
                 p.smem_bytes, 1))
    instance_norm_bwd_sums.launches += 1
    return out


@_bwd_sums_op.register_fake
def _bwd_sums_fake(gy, x, gamma, beta, stats, relu):
    return stats.new_empty(stats.shape)


@torch.library.custom_op("mtta::instance_norm_bwd_apply", mutates_args=(), device_types="cpu")
def _bwd_apply_op(gy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  stats: torch.Tensor, sums: torch.Tensor, n: float, relu: bool) -> torch.Tensor:
    return instance_norm_bwd_apply_plain(gy, x, gamma, beta, stats, sums, n, relu)


@_bwd_apply_op.register_kernel("cuda")
def _bwd_apply_cuda(gy, x, gamma, beta, stats, sums, n, relu):
    _check_inputs(x, gamma, beta)
    _check_gy(gy, x)
    _check_sums(stats, x, "stats")
    _check_sums(sums, x, "sums")
    dx = torch.empty_like(x)
    p = split_plan_for(x, gy, dx, backward=True)
    B, S, C, bf16 = _geometry(x)
    _split_call(_library().mtta_instance_norm_bwd_apply, "bwd_apply", x, p,
                (gy.data_ptr(), x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), stats.data_ptr(), sums.data_ptr(),
                 dx.data_ptr(), B, S, C, bf16, int(relu), float(n), p.vec, p.rows, p.grid[0], p.chunks))
    instance_norm_bwd_apply.launches += 1
    return dx


@_bwd_apply_op.register_fake
def _bwd_apply_fake(gy, x, gamma, beta, stats, sums, n, relu):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def instance_norm_stats(x: torch.Tensor) -> torch.Tensor:
    """``stats`` without autograd: f32 ``[2, B, C]`` (sum x, sum x^2) of NDHWC
    ``x``. A CUDA tensor launches the kernel or raises; a CPU tensor takes
    the plain version."""
    _check_device(x)
    with torch.no_grad():
        return _stats_op(x)


def instance_norm_apply(x, gamma, beta, sums, *, n: float, eps: float = 1e-5, relu: bool = True):
    """``apply`` without autograd: ``(y, stats)`` from the global ``sums``."""
    _check_device(x)
    with torch.no_grad():
        return _apply_op(x, gamma, beta, sums, float(n), float(eps), bool(relu))


def instance_norm_bwd_sums(gy, x, gamma, beta, stats, *, relu: bool) -> torch.Tensor:
    """``bwd_sums`` without autograd: f32 ``[2, B, C]`` (sum g, sum g * xhat)."""
    _check_device(x)
    with torch.no_grad():
        return _bwd_sums_op(gy.contiguous(), x, gamma, beta, stats, bool(relu))


def instance_norm_bwd_apply(gy, x, gamma, beta, stats, sums, *, n: float, relu: bool) -> torch.Tensor:
    """``bwd_apply`` without autograd: dx from the global ``sums``."""
    _check_device(x)
    with torch.no_grad():
        return _bwd_apply_op(gy.contiguous(), x, gamma, beta, stats, sums, float(n), bool(relu))


for _w in (instance_norm_stats, instance_norm_apply, instance_norm_bwd_sums, instance_norm_bwd_apply):
    _w.launches = 0


class _SplitNorm(torch.autograd.Function):
    """stats -> ``reduce`` -> apply; backward bwd_sums -> ``reduce`` ->
    bwd_apply. dgamma and dbeta come from this slab's own sums: the sum of
    the params' gradients over the ranks adds the others'."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, relu, n, reduce):
        sums = reduce(_stats_op(x))
        y, stats = _apply_op(x, gamma, beta, sums, n, eps, relu)
        ctx.relu, ctx.n, ctx.reduce = relu, n, reduce
        ctx.save_for_backward(x, gamma, beta, stats)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, gamma, beta, stats = ctx.saved_tensors
        gy = gy.contiguous()
        local = _bwd_sums_op(gy, x, gamma, beta, stats, ctx.relu)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _bwd_apply_op(gy, x, gamma, beta, stats, ctx.reduce(local), ctx.n, ctx.relu)
        return dx, local[1].sum(dim=0), local[0].sum(dim=0), None, None, None, None


def split_instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *, n: float,
                        reduce: Callable[[torch.Tensor], torch.Tensor], eps: float = 1e-5,
                        act: Optional[str] = "relu") -> torch.Tensor:
    """``fused_instance_norm`` of a volume whose depth is split between ranks:
    ``x`` [B, D_slab, H, W, C] is this rank's slab, ``n`` the element count
    of a (b, c) over the whole depth, and ``reduce`` sums an f32 ``[2, B, C]``
    tensor over the ranks into a new tensor (no gradient). Differentiable in
    x, gamma and beta; gamma's and beta's gradients are this slab's part."""
    relu = _check_act(act)
    _check_device(x)
    return _SplitNorm.apply(x, gamma, beta, float(eps), relu, float(n), reduce)
