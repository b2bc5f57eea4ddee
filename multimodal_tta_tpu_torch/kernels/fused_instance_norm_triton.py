"""The earlier, three-launch Triton forward of the fused InstanceNorm.

No longer on any path of the port: ``kernels/fused_instance_norm.py`` launches
the CUDA C++ kernels of ``csrc/fused_instance_norm.cu``. This file stays only
so that ``chip_smoke.py`` can time the earlier kernel beside the new one in
one run (``_forward`` below); nothing in ``models/`` or ``tta/`` imports it.

Replaces the TPU kernel
``multimodal_tta_tpu/pallas/fused_instance_norm.py::fused_instance_norm``
(``_stats_kernel`` :53-70 and ``_norm_kernel`` :73-82, the two
``pl.pallas_call``s at :114 and :136). Same function on NDHWC ``x``
``[B, D, H, W, C]``: per-(B, C) mean and variance over D*H*W, then
``act((x - mean) * rsqrt(var + eps) * gamma + beta)`` written in x's dtype.
Unlike the Pallas kernel it clamps ``var = max(E[x^2] - E[x]^2, 0)``, as the
model's norm layer does (``models/layers.py:73-82`` in the JAX package).

What bounds it: bytes. There is no tensor-core work (a few flops per
element), so the card's memory rate is the roof. The two-moment schedule
reads x twice and writes y once (2R + 1W); the least any implementation
must move is one read of x and one write of y (1R + 1W), which a kernel
could reach only by holding a whole (B, C) slice on chip — a level-0 slice
is 48*144*144 elements per channel, far beyond one SM's shared memory.

What the design does about it:
  * The TPU grid walks its spatial blocks in order and carries the running
    sum in VMEM. Hopper runs blocks in parallel and in no order, so pass 1
    (``stats``) has each program reduce a contiguous chunk of rows into
    per-block f32 partial sums ``[B, nblk, C]`` — no atomics, so the result
    is deterministic run to run. ``finish`` folds the partials into mean and
    rstd ``[B, C]`` (a few KB). Pass 2 (``norm``) fuses centring, scaling,
    the affine and the optional ReLU into one read and one write.
  * NDHWC keeps C innermost: a tile is ``BLOCK_S`` rows by ``BLOCK_C``
    channels, and for C <= 128 a whole tile is one contiguous run of memory,
    so loads are coalesced and vectorised (C is a compile-time constant).
  * The chunk count ``nblk`` is chosen so that pass 1 puts on the order of
    a thousand programs in flight, enough to fill 132 SMs at every level.

Importing this module imports nothing from Triton; ``build()`` does, on the
first launch, so the package imports on machines without Triton.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

# pass-1 tile of 4096 f32 accumulators (x2), pass-2 tile of 8192 elements
_STATS_TILE = 4096
_NORM_TILE = 8192
# pass-1 programs to aim for: several waves on 132 SMs
_STATS_PROGRAMS = 1024


@functools.cache
def build() -> SimpleNamespace:
    """Define the three jitted kernels (Triton compiles each specialisation
    at its first launch, into ``TRITON_CACHE_DIR``)."""
    import triton
    import triton.language as tl

    @triton.jit
    def stats_kernel(x_ptr, psum_ptr, psq_ptr, S, rows_per_prog,
                     C: tl.constexpr, BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        pid_s = tl.program_id(0)
        b = tl.program_id(1)
        pid_c = tl.program_id(2)
        nblk = tl.num_programs(0)
        offs_c = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = offs_c < C
        x_base = x_ptr + b.to(tl.int64) * S * C
        acc_s = tl.zeros((BLOCK_S, BLOCK_C), dtype=tl.float32)
        acc_q = tl.zeros((BLOCK_S, BLOCK_C), dtype=tl.float32)
        row0 = pid_s * rows_per_prog
        for r in range(row0, row0 + rows_per_prog, BLOCK_S):
            rows = r + tl.arange(0, BLOCK_S)
            m = (rows < S)[:, None] & cmask[None, :]
            v = tl.load(x_base + rows[:, None] * C + offs_c[None, :], mask=m, other=0.0)
            v = v.to(tl.float32)
            acc_s += v
            acc_q += v * v
        out = (b * nblk + pid_s) * C + offs_c
        tl.store(psum_ptr + out, tl.sum(acc_s, axis=0), mask=cmask)
        tl.store(psq_ptr + out, tl.sum(acc_q, axis=0), mask=cmask)

    @triton.jit
    def finish_kernel(psum_ptr, psq_ptr, mean_ptr, rstd_ptr, nblk, n, eps,
                      C: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(0)
        pid_c = tl.program_id(1)
        offs_c = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = offs_c < C
        s = tl.zeros((BLOCK_C,), dtype=tl.float32)
        q = tl.zeros((BLOCK_C,), dtype=tl.float32)
        for k in range(0, nblk):
            idx = (b * nblk + k) * C + offs_c
            s += tl.load(psum_ptr + idx, mask=cmask, other=0.0)
            q += tl.load(psq_ptr + idx, mask=cmask, other=0.0)
        mean = s / n
        var = tl.maximum(q / n - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        tl.store(mean_ptr + b * C + offs_c, mean, mask=cmask)
        tl.store(rstd_ptr + b * C + offs_c, rstd, mask=cmask)

    @triton.jit
    def norm_kernel(x_ptr, y_ptr, mean_ptr, rstd_ptr, g_ptr, beta_ptr, S,
                    C: tl.constexpr, BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
                    RELU: tl.constexpr):
        pid_s = tl.program_id(0)
        b = tl.program_id(1)
        pid_c = tl.program_id(2)
        offs_c = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = offs_c < C
        mean = tl.load(mean_ptr + b * C + offs_c, mask=cmask, other=0.0)
        rstd = tl.load(rstd_ptr + b * C + offs_c, mask=cmask, other=0.0)
        g = tl.load(g_ptr + offs_c, mask=cmask, other=0.0)
        beta = tl.load(beta_ptr + offs_c, mask=cmask, other=0.0)
        rows = pid_s * BLOCK_S + tl.arange(0, BLOCK_S)
        m = (rows < S)[:, None] & cmask[None, :]
        base = b.to(tl.int64) * S * C
        offs = rows[:, None] * C + offs_c[None, :]
        x = tl.load(x_ptr + base + offs, mask=m, other=0.0).to(tl.float32)
        y = (x - mean[None, :]) * rstd[None, :] * g[None, :] + beta[None, :]
        if RELU:
            y = tl.maximum(y, 0.0)
        tl.store(y_ptr + base + offs, y.to(y_ptr.dtype.element_ty), mask=m)

    return SimpleNamespace(
        stats=stats_kernel, finish=finish_kernel, norm=norm_kernel,
        version=triton.__version__,
    )


def _forward(x, gamma, beta, eps: float, relu: bool):
    """Run the three Triton kernels on contiguous NDHWC CUDA tensors (f32 or
    bf16 x, f32 gamma and beta); returns y. For timing comparisons only."""
    import torch

    B, D, H, W, C = x.shape
    S = D * H * W
    k = build()
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
    return y
