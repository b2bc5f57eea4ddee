"""Parity of the port's fused InstanceNorm (multimodal_tta_tpu_torch/kernels)
with the JAX package's Pallas kernel (interpret mode), its jnp reference and
the model's norm layer. On the CPU the wrapper runs the plain versions; the
CUDA kernels themselves are held against them on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py). What of the kernels is
plain Python is tested here: the launch plan, and the order of their folds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.models.layers import InstanceNorm as JaxInstanceNorm
from multimodal_tta_tpu.pallas.fused_instance_norm import (
    fused_instance_norm as pallas_fused_instance_norm,
    instance_norm_reference,
)
from multimodal_tta_tpu_torch.kernels.fused_instance_norm import (
    THREADS,
    _plain_forward,
    fused_instance_norm,
    instance_norm_backward,
    instance_norm_backward_plain,
    instance_norm_forward,
    instance_norm_plain,
    plan,
    plan_chunks,
)

torch.set_num_threads(1)

F32_TOL = 5e-5
BF16_TOL = 5e-2


def _inputs(shape, seed=3):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    g = (rng.rand(c) + 0.5).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    return x, g, b


def _both(shape, jdtype, tdtype, act="relu"):
    x, g, b = _inputs(shape)
    xj = jnp.asarray(x).astype(jdtype)
    pallas = pallas_fused_instance_norm(xj, jnp.asarray(g), jnp.asarray(b), act=act, interpret=True)
    ref = instance_norm_reference(xj, jnp.asarray(g), jnp.asarray(b), act=act)
    xt = torch.from_numpy(x).to(tdtype)
    out = fused_instance_norm(xt, torch.from_numpy(g), torch.from_numpy(b), act=act)
    assert out.dtype == tdtype and out.shape == xt.shape
    return out.float().numpy(), np.asarray(pallas, np.float32), np.asarray(ref, np.float32)


@pytest.mark.parametrize("shape", [(2, 4, 12, 12, 32), (1, 3, 8, 8, 64), (2, 2, 6, 10, 16)])
def test_parity_f32(shape):
    out, pallas, ref = _both(shape, jnp.float32, torch.float32)
    np.testing.assert_allclose(out, pallas, atol=F32_TOL)
    np.testing.assert_allclose(out, ref, atol=F32_TOL)


def test_parity_bf16():
    out, pallas, ref = _both((2, 4, 12, 12, 32), jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(out, pallas, atol=BF16_TOL)
    np.testing.assert_allclose(out, ref, atol=BF16_TOL)


def test_no_act():
    out, pallas, ref = _both((1, 2, 8, 8, 32), jnp.float32, torch.float32, act=None)
    assert out.min() < 0  # relu really off
    np.testing.assert_allclose(out, pallas, atol=F32_TOL)
    np.testing.assert_allclose(out, ref, atol=F32_TOL)


def _jax_layer(x, g, b, relu):
    layer = JaxInstanceNorm()

    def f(xx, scale, bias):
        y = layer.apply({"params": {"scale": scale, "bias": bias}}, xx)
        return jax.nn.relu(y) if relu else y

    return f


@pytest.mark.parametrize("relu", [True, False])
def test_forward_matches_model_layer(relu):
    """The model's norm (with its variance clamp), not only the kernel's
    reference: one channel is constant, where E[x^2]-E[x]^2 rounds below 0."""
    x, g, b = _inputs((2, 4, 6, 6, 8), seed=5)
    x[1, ..., 3] = 7.25
    want = _jax_layer(x, g, b, relu)(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = fused_instance_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b),
                              act="relu" if relu else None)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


@pytest.mark.parametrize("relu", [True, False])
def test_backward_matches_jax_vjp(relu):
    """The autograd Function's plain backward against jax.vjp of the model's
    InstanceNorm (+ReLU), f32, atol 1e-5."""
    x, g, b = _inputs((2, 3, 6, 5, 8), seed=11)
    gy = np.random.RandomState(12).randn(*x.shape).astype(np.float32)
    f = _jax_layer(x, g, b, relu)
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = [np.asarray(a) for a in vjp(jnp.asarray(gy))]

    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = fused_instance_norm(xt, gt, bt, act="relu" if relu else None)
    got = torch.autograd.grad(y, (xt, gt, bt), torch.from_numpy(gy))
    for name, u, v in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(u.numpy(), v, atol=1e-5, err_msg=name)


def test_backward_bf16_returns_input_dtype():
    x, g, b = _inputs((1, 2, 4, 4, 16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    y = fused_instance_norm(xt, gt, torch.from_numpy(b))
    dx, dg = torch.autograd.grad(y.float().sum(), (xt, gt))
    assert dx.dtype == torch.bfloat16 and dg.dtype == torch.float32


def test_cpu_wrapper_is_plain_and_launches_nothing():
    x, g, b = (torch.from_numpy(a) for a in _inputs((1, 2, 4, 4, 16)))
    before = fused_instance_norm.launches
    assert torch.equal(fused_instance_norm(x, g, b), instance_norm_plain(x, g, b))
    assert fused_instance_norm.launches == before


def test_other_devices_never_reach_the_plain_version():
    """Only a CPU tensor takes the plain version; any other device launches
    a kernel or raises (here: 'meta', which has no kernel)."""
    x = torch.empty((1, 2, 4, 4, 16), device="meta")
    g = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_instance_norm(x, g, g)


def test_rejects_unknown_act():
    x, g, b = (torch.from_numpy(a) for a in _inputs((1, 2, 4, 4, 16)))
    with pytest.raises(ValueError):
        fused_instance_norm(x, g, b, act="gelu")



# ---- the launch plan ---------------------------------------------------------

# an H100: shared memory a block may opt in to, SMs, L2 bytes
CARD = dict(smem_optin=232448, sms=132, l2_bytes=50 * 2 ** 20)
# the flagship's nine norm shapes at batch 2 (D, H, W, C) and the plan each
# must take in bf16: (regime, cluster) forward, (regime, cluster) backward
PATH_PLANS = {
    (48, 144, 144, 32): (("streaming", 1), ("streaming", 1)),
    (24, 72, 72, 32): (("streaming", 1), ("streaming", 1)),
    (24, 72, 72, 64): (("streaming", 1), ("streaming", 1)),
    (12, 36, 36, 64): (("resident", 8), ("resident", 8)),
    (12, 36, 36, 128): (("resident", 8), ("resident", 8)),
    (6, 18, 18, 128): (("resident", 4), ("resident", 8)),
    (6, 18, 18, 256): (("resident", 4), ("resident", 8)),
    (3, 9, 9, 256): (("resident", 1), ("resident", 1)),
    (3, 9, 9, 512): (("resident", 1), ("resident", 1)),
}


def _check_plan(p, B, S, C, itemsize, arrays, card=CARD, ctas_per_sm=4):
    """The invariants every plan must keep, and exact coverage."""
    assert 1 <= p.cluster <= 8 and p.smem_bytes <= card["smem_optin"]
    if p.regime == "resident":
        assert p.cg * itemsize == 32 and C % p.cg == 0 and p.vec * itemsize == 16
        assert p.grid == (p.cluster, C // p.cg, B)
        assert p.smem_bytes == p.rows * 32 * arrays and p.ws_floats == 0
    else:
        assert p.ctas <= ctas_per_sm * card["sms"]  # co-resident, or the grid barrier hangs
        assert C % p.vec == 0 and p.ws_floats == B * p.chunks * 2 * C
        assert p.smem_bytes == (THREADS * 2 * p.vec + 2 * C) * 4
    rows = {}
    for b, c0, c1, r0, r1 in plan_chunks(p, B, S, C):
        assert 0 <= r0 < r1 <= S and r1 - r0 <= p.rows
        rows.setdefault((b, c0, c1), []).append((r0, r1))
    by_b = {}
    for (b, c0, c1), spans in rows.items():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == S
        assert all(a[1] == nxt[0] for a, nxt in zip(spans, spans[1:]))  # no gap, no overlap
        by_b.setdefault(b, []).append((c0, c1))
    assert sorted(by_b) == list(range(B))
    for spans in by_b.values():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == C
        assert all(a[1] == nxt[0] for a, nxt in zip(spans, spans[1:]))


@pytest.mark.parametrize("arrays", [1, 2])
@pytest.mark.parametrize("shape", sorted(PATH_PLANS))
def test_plan_of_the_path_shapes(shape, arrays):
    d, h, w, c = shape
    S = d * h * w
    p = plan(2, S, c, 2, arrays=arrays, **CARD)
    assert (p.regime, p.cluster) == PATH_PLANS[shape][arrays - 1]
    assert p.vec == 8 and p.cg == (16 if p.regime == "resident" else 0)
    # only the 127 MB tensors (and gy + x of [24,72,72,64]) exceed the L2
    assert p.hbm_reads == (2 if arrays * 2 * S * c * 2 > CARD["l2_bytes"] else 1)
    _check_plan(p, 2, S, c, 2, arrays)
    pf = plan(2, S, c, 4, arrays=arrays, **CARD)  # the same shapes in f32
    assert pf.vec == 4 and pf.cg in (0, 8)
    _check_plan(pf, 2, S, c, 4, arrays)


# the same nine shapes in the training step at the recipe's batch 8: (regime,
# cluster, chunks per sample) forward and backward, bf16 and f32 alike
TRAIN_PLANS = {
    (48, 144, 144, 32): (("streaming", 1, 66), ("streaming", 1, 66)),
    (24, 72, 72, 32): (("streaming", 1, 66), ("streaming", 1, 66)),
    (24, 72, 72, 64): (("streaming", 1, 66), ("streaming", 1, 66)),
    (12, 36, 36, 64): (("resident", 8, 8), ("resident", 8, 8)),
    (12, 36, 36, 128): (("resident", 8, 8), ("resident", 8, 8)),
    (6, 18, 18, 128): (("resident", 4, 4), ("resident", 8, 8)),
    (6, 18, 18, 256): (("resident", 4, 4), ("resident", 8, 8)),
    (3, 9, 9, 256): (("resident", 1, 1), ("resident", 1, 1)),
    (3, 9, 9, 512): (("resident", 1, 1), ("resident", 1, 1)),
}


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("arrays", [1, 2])
@pytest.mark.parametrize("shape", sorted(TRAIN_PLANS))
def test_plan_of_the_batch8_training_shapes(shape, arrays, itemsize):
    """Batch 8: the largest call is [8,48,144,144,32], 509 MB in bf16 and
    1.02 GB in f32. The streaming grid stays co-resident (528 CTAs, 66 chunks
    a sample), the resident grid's B axis is 8, and every element offset of
    the call, across the batch, fits the kernels' 64-bit offsets as well as
    a 32-bit index (254.8M elements)."""
    d, h, w, c = shape
    S, B = d * h * w, 8
    p = plan(B, S, c, itemsize, arrays=arrays, **CARD)
    assert (p.regime, p.cluster, p.chunks) == TRAIN_PLANS[shape][arrays - 1]
    if p.regime == "streaming":  # every streaming call here exceeds the L2: its second walk re-reads HBM
        assert p.grid == (4 * CARD["sms"],) and p.ws_floats == B * 66 * 2 * c and p.hbm_reads == 2
    else:  # a resident slice is read once
        assert p.grid[2] == B and p.hbm_reads == 1
    assert B * S * c < 2 ** 31 and S * c < 2 ** 31
    _check_plan(p, B, S, c, itemsize, arrays)


@pytest.mark.parametrize("case,kw,want", [
    ("C=48 f32 is a multiple of the 8-channel group", dict(B=1, S=105, C=48, itemsize=4), ("resident", 4, 8)),
    ("C=48 bf16 too", dict(B=2, S=243, C=48, itemsize=2), ("resident", 8, 16)),
    ("odd C takes the scalar path", dict(B=2, S=105, C=7, itemsize=4), ("streaming", 1, 0)),
    ("C=8 bf16 fills a vector but not a group", dict(B=2, S=105, C=8, itemsize=2), ("streaming", 8, 0)),
    ("an unaligned pointer takes the scalar path", dict(B=2, S=105, C=32, itemsize=2, aligned=False),
     ("streaming", 1, 0)),
    ("a slice beyond 8 CTAs' shared memory streams", dict(B=1, S=10 ** 6, C=16, itemsize=2), ("streaming", 8, 0)),
    ("more samples than co-resident CTAs", dict(B=1000, S=64, C=3, itemsize=4), ("streaming", 1, 0)),
    ("one row", dict(B=3, S=1, C=16, itemsize=2), ("resident", 8, 16)),
])
@pytest.mark.parametrize("arrays", [1, 2])
def test_plan_of_the_odd_cases(case, kw, want, arrays):
    p = plan(**kw, arrays=arrays, **CARD)
    assert (p.regime, p.vec, p.cg) == want, case
    _check_plan(p, kw["B"], kw["S"], kw["C"], kw["itemsize"], arrays)


def test_plan_respects_a_smaller_card():
    """Half the shared memory, a quarter of the SMs: the slice that was
    resident streams, and the grid shrinks to what is co-resident."""
    small = dict(smem_optin=100 * 1024, sms=33, l2_bytes=10 * 2 ** 20)
    S = 12 * 36 * 36
    p = plan(2, S, 64, 2, arrays=2, ctas_per_sm=2, **small)
    assert p.regime == "streaming" and p.ctas <= 66 and p.hbm_reads == 1
    _check_plan(p, 2, S, 64, 2, 2, card=small, ctas_per_sm=2)
    assert plan(2, S, 64, 2, arrays=1, **small).regime == "resident"


def test_plan_rejects_what_no_regime_can_launch():
    with pytest.raises(ValueError, match="shared memory"):
        plan(1, 10, 40001, 4, **CARD)  # the per-channel totals alone exceed shared memory
    with pytest.raises(ValueError, match="empty"):
        plan(0, 10, 16, 4, **CARD)
    with pytest.raises(ValueError, match="unsupported"):
        plan(1, 10, 16, 8, **CARD)


# ---- the kernels' fold order, emulated --------------------------------------


def _seq_sum(a, axis_len):
    """Sequential f32 sum over axis 0 starting from 0.0, as a thread's loop."""
    acc = np.zeros(a.shape[1:], np.float32)
    for k in range(axis_len):
        acc = acc + a[k]
    return acc


def _emulated_totals(x, p):
    """Per-(b, c) sums of x and x^2 ([B, S, C] f32) folded in the kernels'
    order for plan ``p``: per-thread strided sums, then the CTA's fold, then
    the cluster's ranks or the sample's partials in index order."""
    B, S, C = x.shape
    xx = np.stack([x, x * x], axis=-1)  # [B, S, C, 2]
    tot = np.zeros((B, C, 2), np.float32)
    if p.regime == "resident":
        lanes = THREADS // 2  # threads per half-row vector: rows lane, lane + 128, ...
        for b, c0, c1, r0, r1 in plan_chunks(p, B, S, C):  # ranks come in index order
            part = np.zeros((lanes, c1 - c0, 2), np.float32)
            for lane in range(min(lanes, r1 - r0)):
                rows = xx[b, r0 + lane:r1:lanes, c0:c1]
                part[lane] = _seq_sum(rows, rows.shape[0])
            w = part.reshape(THREADS // 32, 16, c1 - c0, 2)  # warps of 16 lanes per half
            while w.shape[1] > 1:  # the xor-shuffle tree
                w = w[:, 0::2] + w[:, 1::2]
            tot[b, c0:c1] = tot[b, c0:c1] + _seq_sum(w[:, 0], w.shape[0])
        return tot
    lc = min(C // p.vec, THREADS)
    rpi = THREADS // lc
    ws = np.zeros((B, p.chunks, C, 2), np.float32)
    for b, _, _, r0, r1 in plan_chunks(p, B, S, C):
        part = np.zeros((rpi, C, 2), np.float32)
        for rl in range(min(rpi, r1 - r0)):
            rows = xx[b, r0 + rl:r1:rpi]
            part[rl] = _seq_sum(rows, rows.shape[0])
        ws[b, r0 // p.rows] = _seq_sum(part, rpi)
    k = THREADS // min(C, THREADS)
    for b in range(B):
        strided = np.stack([_seq_sum(ws[b, kk::k], len(range(kk, p.chunks, k))) for kk in range(k)])
        tot[b] = _seq_sum(strided, k)
    return tot


@pytest.mark.parametrize("regime,shape,kw", [
    ("resident", (2, 700, 16), dict(smem_optin=232448)),                 # cluster 2
    ("resident", (1, 5000, 8), dict(smem_optin=40 * 1024)),              # cluster 8, over the target
    ("streaming", (2, 3000, 24), dict(smem_optin=12 * 1024, ctas_per_sm=2, sms=8)),  # too big a slice
    ("streaming", (3, 333, 7), dict(smem_optin=232448, ctas_per_sm=1, sms=12)),  # scalar path
])
def test_emulated_fold_order_matches_plain_forward(regime, shape, kw):
    """The kernels' chunked f32 folds give the plain version's statistics and
    output within the f32 tolerance (5e-5; other summation order)."""
    B, S, C = shape
    rng = np.random.RandomState(S)
    x = (rng.randn(B, S, C) * 3 + 1).astype(np.float32)
    g = (rng.rand(C) + 0.5).astype(np.float32)
    beta = (rng.randn(C) * 0.1).astype(np.float32)
    p = plan(B, S, C, 4, l2_bytes=50 * 2 ** 20, **{"sms": 132, **kw})
    assert p.regime == regime and (regime == "streaming" or p.cluster > 1)
    tot = _emulated_totals(x, p)
    n = np.float32(S)
    mean = tot[..., 0] / n
    var = np.maximum(tot[..., 1] / n - mean * mean, np.float32(0))
    rstd = (np.float32(1) / np.sqrt(var + np.float32(1e-5))).astype(np.float32)
    y = np.maximum((x - mean[:, None]) * rstd[:, None] * g + beta, 0)
    want, wmean, wrstd = _plain_forward(torch.from_numpy(x).view(B, S, 1, 1, C), torch.from_numpy(g),
                                        torch.from_numpy(beta), 1e-5, True)
    np.testing.assert_allclose(mean, wmean.numpy(), atol=1e-6)
    np.testing.assert_allclose(rstd, wrstd.numpy(), rtol=1e-5)
    np.testing.assert_allclose(y, want.numpy().reshape(B, S, C), atol=F32_TOL)


# ---- the plain backward ------------------------------------------------------


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_backward_plain_matches_vjp_of_the_reference(relu, need_dx):
    """``instance_norm_backward_plain`` (what the backward kernel is held
    against) vs jax.vjp of the JAX package's ``instance_norm_reference``,
    f32, atol 2e-5 on dx and 2e-5 * sqrt(N) on the sums over N elements."""
    act = "relu" if relu else None
    x, g, b = _inputs((2, 3, 6, 5, 8), seed=21)
    gy = np.random.RandomState(22).randn(*x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda xx, gg, bb: instance_norm_reference(xx, gg, bb, act=act),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = [np.asarray(a) for a in vjp(jnp.asarray(gy))]
    xt, gt, bt = (torch.from_numpy(a) for a in (x, g, b))
    _, mean, rstd = _plain_forward(xt, gt, bt, 1e-5, relu)
    dx, dgamma, dbeta = instance_norm_backward_plain(torch.from_numpy(gy), xt, gt, bt, mean, rstd,
                                                     relu, need_dx)
    if need_dx:
        np.testing.assert_allclose(dx.numpy(), want[0], atol=2e-5)
    else:
        assert dx is None
    sum_tol = 2e-5 * np.sqrt(x.size / x.shape[-1])
    np.testing.assert_allclose(dgamma.numpy(), want[1], atol=sum_tol)
    np.testing.assert_allclose(dbeta.numpy(), want[2], atol=sum_tol)


def test_backward_wrapper_on_the_cpu_is_the_plain_backward():
    x, g, b = (torch.from_numpy(a) for a in _inputs((1, 2, 4, 4, 16)))
    gy = torch.from_numpy(np.random.RandomState(1).randn(*x.shape).astype(np.float32))
    want_y, mean, rstd = _plain_forward(x, g, b, 1e-5, True)
    before = (fused_instance_norm.backward_launches, instance_norm_backward_plain.cuda_calls)
    y, stats = instance_norm_forward(x, g, b)
    assert torch.equal(y, want_y) and torch.equal(stats, torch.stack((mean, rstd)))
    got = instance_norm_backward(gy, x, g, b, stats, relu=True)
    want = instance_norm_backward_plain(gy, x, g, b, mean, rstd, True)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert (fused_instance_norm.backward_launches, instance_norm_backward_plain.cuda_calls) == before
    with pytest.raises(ValueError, match="no kernel for device"):
        instance_norm_backward(gy.to("meta"), x.to("meta"), g, b, torch.stack((mean, rstd)), relu=True)
