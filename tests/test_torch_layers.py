"""Parity of the port's building blocks (multimodal_tta_tpu_torch/models/
layers.py) with the flax ones, weights carried across by models/convert.py:
f32, atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.models import layers as jl
from multimodal_tta_tpu_torch.models import layers as tl
from multimodal_tta_tpu_torch.models.convert import variables_from_flax
from tests._torch_port import load_flax, np_params, randomize, to_ncdhw, to_ndhwc

torch.set_num_threads(1)

ATOL = 1e-5


def _check(flax_mod, torch_mod, x, seed=0):
    params = randomize(np_params(flax_mod, x), seed + 100)
    want = np.asarray(flax_mod.apply({"params": params}, jnp.asarray(x)))
    load_flax(torch_mod, params)
    with torch.no_grad():
        got = to_ndhwc(torch_mod(to_ncdhw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("stride,shape", [
    (1, (2, 8, 8, 8, 3)),
    (2, (2, 8, 8, 8, 3)),
    (2, (1, 7, 9, 6, 3)),  # odd dims: flax SAME pads (1, 1) there
])
def test_conv_block(stride, shape):
    _check(jl.ConvBlock(features=5, strides=stride), tl.ConvBlock(3, 5, strides=stride), _x(shape))


def test_conv_block_without_norm_has_bias_and_act():
    _check(jl.ConvBlock(features=4, use_norm=False, act="ELU"),
           tl.ConvBlock(3, 4, use_norm=False, act="ELU"), _x((1, 4, 4, 4, 3)))


@pytest.mark.parametrize("in_ch,feat,stride", [(3, 6, 2), (4, 6, 1), (6, 6, 1)])
def test_residual_unit(in_ch, feat, stride):
    jm = jl.ResidualUnit(features=feat, strides=stride, subunits=2)
    tm = tl.ResidualUnit(in_ch, feat, stride, subunits=2)
    assert (tm.residual_proj is not None) == (stride != 1 or in_ch != feat)
    _check(jm, tm, _x((2, 8, 8, 8, in_ch), seed=1))


def test_transposed_conv_up_asymmetric_kernel():
    """A random (hence asymmetric) kernel: convert.py's spatial flip is what
    makes flax's nn.ConvTranspose and conv_transpose3d agree."""
    _check(jl.TransposedConvUp(features=4, strides=2), tl.TransposedConvUp(6, 4, 2),
           _x((2, 3, 4, 5, 6), seed=2))


def test_transposed_conv_flip_is_needed():
    jm = jl.TransposedConvUp(features=4, strides=2)
    x = _x((1, 2, 2, 2, 3), seed=4)
    params = randomize(np_params(jm, x), 7)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = load_flax(tl.TransposedConvUp(3, 4, 2), params)
    with torch.no_grad():
        tm.up.weight.copy_(tm.up.weight.flip(2, 3, 4))  # undo the flip
        got = to_ndhwc(tm(to_ncdhw(x)))
    assert np.abs(got - want).max() > 1e-2


@pytest.mark.parametrize("name", ["RELU", "LEAKYRELU", "PRELU", "GELU", "SILU", "SWISH",
                                  "TANH", "SIGMOID", "ELU"])
def test_get_act(name):
    x = _x((64,), seed=3) * 3
    want = np.asarray(jl.get_act(name)(jnp.asarray(x)))
    got = tl.get_act(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_unported_norms_raise():
    """An unknown norm raises. BATCH is ported (it raised before the
    BatchNorm slice): flax's ``Norm("BATCH")`` in training mode (batch
    statistics, running statistics moved once) and in inference mode
    (running statistics), within ATOL; GROUP, LAYER and NONE are in
    tests/test_torch_seg_models.py::test_norm_kinds."""
    with pytest.raises(ValueError, match="Unknown norm"):
        tl.Norm("SPECTRAL", 4)
    x = _x((2, 4, 6, 5, 4), seed=11) * 2.0 + 1.0
    jm = jl.Norm("BATCH")
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    v = {"params": randomize(jax.tree_util.tree_map(np.asarray, v["params"]), 5),
         "batch_stats": {"norm": {"mean": np.full(4, 0.5, np.float32), "var": np.full(4, 2.0, np.float32)}}}
    tm = tl.Norm("BATCH", 4)
    tm.load_state_dict(variables_from_flax(v), strict=True)
    for train in (False, True):  # inference first: training moves the port's statistics in place
        out = jm.apply(v, jnp.asarray(x), train=train, mutable=["batch_stats"] if train else False)
        want = np.asarray(out[0] if train else out)
        tm.train(train)
        with torch.no_grad():
            got = to_ndhwc(tm(to_ncdhw(x)))
        np.testing.assert_allclose(got, want, atol=ATOL)
        if train:
            for k in ("mean", "var"):
                np.testing.assert_allclose(getattr(tm.norm, k).numpy(), np.asarray(out[1]["batch_stats"]["norm"][k]),
                                           rtol=1e-5)


def test_bf16_block_casts_like_flax():
    x = _x((1, 8, 8, 8, 3), seed=5)
    jm = jl.ConvBlock(features=5, strides=2, dtype=jnp.bfloat16)
    params = randomize(np_params(jm, x), 9)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)), np.float32)
    tm = load_flax(tl.ConvBlock(3, 5, strides=2, dtype=torch.bfloat16), params)
    with torch.no_grad():
        y = tm(to_ncdhw(x))
    assert y.dtype == torch.bfloat16
    # one bf16 rounding of the conv output feeds the norm, which amplifies it
    # by rstd; outputs are O(1), so a few bf16 ulps
    np.testing.assert_allclose(to_ndhwc(y), want, atol=5e-2)
