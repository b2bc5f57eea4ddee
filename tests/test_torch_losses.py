"""Parity of the port's Tent objective (multimodal_tta_tpu_torch/ops/
losses.py:entropy_loss) with the JAX one: value, per-sample value (the JAX
Tent step's vmap) and gradient, in both focus modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.ops.losses import entropy_loss as jax_entropy_loss
from multimodal_tta_tpu_torch.ops.losses import entropy_loss

torch.set_num_threads(1)

CASES = [(s, f) for s in (True, False) for f in ("all", "uncertain")]


def _logits(sigmoid, seed=0):
    shape = (3, 4, 5, 6, 1 if sigmoid else 3)
    return (np.random.RandomState(seed).randn(*shape) * 3).astype(np.float32)


@pytest.mark.parametrize("sigmoid,focus", CASES)
def test_value_and_grad(sigmoid, focus):
    x = _logits(sigmoid)
    want, want_g = jax.value_and_grad(
        lambda l: jax_entropy_loss(l, sigmoid=sigmoid, focus=focus))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = entropy_loss(xt, sigmoid=sigmoid, focus=focus)
    (got_g,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("sigmoid,focus", CASES)
def test_per_sample(sigmoid, focus):
    x = _logits(sigmoid, seed=1)
    want = jax.vmap(lambda l: jax_entropy_loss(l[None], sigmoid=sigmoid, focus=focus))(jnp.asarray(x))
    got = entropy_loss(torch.from_numpy(x), sigmoid=sigmoid, focus=focus, per_sample=True)
    assert tuple(got.shape) == (x.shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_unknown_focus_raises():
    with pytest.raises(ValueError):
        entropy_loss(torch.zeros(1, 2, 2, 2, 1), focus="most")
