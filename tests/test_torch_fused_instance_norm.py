"""Parity of the port's fused InstanceNorm (multimodal_tta_tpu_torch/kernels)
with the JAX package's Pallas kernel (interpret mode), its jnp reference and
the model's norm layer. On the CPU the wrapper runs the plain version; the
Triton kernel itself is held against it on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py)."""

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
    fused_instance_norm,
    instance_norm_plain,
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

