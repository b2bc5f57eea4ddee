"""Fused InstanceNorm + affine + optional ReLU over NDHWC ``[B, D, H, W, C]``.

The port of ``multimodal_tta_tpu/pallas/fused_instance_norm.py``. On the
port it is the norm of every ``ConvBlock`` (``models/layers.py``), so it
carries the main path's forward.

* ``fused_instance_norm`` — the wrapper. A CUDA tensor launches the Triton
  kernel (``fused_instance_norm_triton.py``) or raises; a CPU tensor takes
  the plain version. No other route exists: there is no fallback from a
  failed launch. ``fused_instance_norm.launches`` counts kernel launches.
* ``instance_norm_plain`` — the plain PyTorch version of the same function:
  what the CPU tests run, and what the kernel is held against on the card.

The gradient is a ``torch.autograd.Function``: the forward is the kernel (or
the plain version on the CPU) and saves ``x``, the output and the f32
mean/rstd; the backward is plain PyTorch for dx, dgamma and dbeta through
the ReLU mask. The JAX package has no backward kernel either (XLA
differentiates the jnp norm); a hand-written one is a ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch

_REDUCE = (1, 2, 3)  # D, H, W of NDHWC
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# pass-1 tile of 4096 f32 accumulators (x2), pass-2 tile of 8192 elements
_STATS_TILE = 4096
_NORM_TILE = 8192
# pass-1 programs to aim for: several waves on 132 SMs
_STATS_PROGRAMS = 1024


def _check_act(act: Optional[str]) -> bool:
    if act not in (None, "relu"):
        raise ValueError(f"fused_instance_norm: act must be None or 'relu', got {act!r}")
    return act == "relu"


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


def _launch_kernel(x, gamma, beta, eps: float, relu: bool):
    """Run the Triton kernel on CUDA tensors; returns (y, mean, rstd)."""
    if x.dim() != 5:
        raise ValueError(f"fused_instance_norm: x must be [B,D,H,W,C], got {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused_instance_norm: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_instance_norm: x must be contiguous NDHWC")
    B, D, H, W, C = x.shape
    S = D * H * W
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (C,) or t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"fused_instance_norm: {name} must be a contiguous f32 [{C}] tensor on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if S == 0 or B == 0 or C == 0:
        raise ValueError(f"fused_instance_norm: empty input {tuple(x.shape)}")
    if S * C >= 2**31:
        raise ValueError("fused_instance_norm: one sample must hold fewer than 2**31 elements")

    from . import fused_instance_norm_triton

    k = fused_instance_norm_triton.build()
    block_c = min(1 << (C - 1).bit_length(), 128)
    n_cblk = -(-C // block_c)

    stats_s = _STATS_TILE // block_c
    nblk = max(1, min(-(-S // stats_s), -(-_STATS_PROGRAMS // (B * n_cblk))))
    rows = -(-S // nblk)
    rows_per_prog = -(-rows // stats_s) * stats_s  # a whole number of tiles
    nblk = -(-S // rows_per_prog)

    psum = torch.empty((B, nblk, C), device=x.device, dtype=torch.float32)
    psq = torch.empty_like(psum)
    mean = torch.empty((B, C), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    y = torch.empty_like(x)

    k.stats[(nblk, B, n_cblk)](
        x, psum, psq, S, rows_per_prog,
        C=C, BLOCK_S=stats_s, BLOCK_C=block_c, num_warps=8,
    )
    k.finish[(B, n_cblk)](
        psum, psq, mean, rstd, nblk, float(S), float(eps),
        C=C, BLOCK_C=block_c, num_warps=4,
    )
    norm_s = _NORM_TILE // block_c
    k.norm[(-(-S // norm_s), B, n_cblk)](
        x, y, mean, rstd, gamma, beta, S,
        C=C, BLOCK_S=norm_s, BLOCK_C=block_c, RELU=relu, num_warps=8,
    )
    fused_instance_norm.launches += 1
    return y, mean, rstd


class _FusedInstanceNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, relu: bool):
        if x.device.type == "cuda":
            y, mean, rstd = _launch_kernel(x, gamma, beta, eps, relu)
        elif x.device.type == "cpu":
            y, mean, rstd = _plain_forward(x, gamma, beta, eps, relu)
        else:
            raise ValueError(f"fused_instance_norm: no kernel for device {x.device}")
        ctx.relu = relu
        ctx.save_for_backward(x, gamma, mean, rstd, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, gamma, mean, rstd, y = ctx.saved_tensors
        shp = (x.shape[0], 1, 1, 1, x.shape[-1])
        mean, rstd = mean.view(shp), rstd.view(shp)
        xhat = (x.float() - mean) * rstd
        g = gy.float()
        if ctx.relu:
            g = g * (y > 0)
        dgamma = (g * xhat).sum(dim=(0,) + _REDUCE) if ctx.needs_input_grad[1] else None
        dbeta = g.sum(dim=(0,) + _REDUCE) if ctx.needs_input_grad[2] else None
        dx = None
        if ctx.needs_input_grad[0]:
            # d/dx of (x - mean) * rsqrt(var + eps) with var = E[x^2] - E[x]^2;
            # the clamp at 0 only binds for constant channels, where xhat = 0
            dxhat = g * gamma
            dx = rstd * (
                dxhat
                - dxhat.mean(dim=_REDUCE, keepdim=True)
                - xhat * (dxhat * xhat).mean(dim=_REDUCE, keepdim=True)
            )
            dx = dx.to(x.dtype)
        return dx, dgamma, dbeta, None, None


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
    mean/var per (B, C) taken in f32. Differentiable in x, gamma and beta."""
    return _FusedInstanceNormFn.apply(x, gamma, beta, float(eps), _check_act(act))


fused_instance_norm.launches = 0

