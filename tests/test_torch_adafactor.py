"""The port's Adafactor (``core/optim.py:Adafactor``) against the
reference's chain, ``add_decayed_weights`` + ``optax.adafactor`` as
``multimodal_tta_tpu/core/optim.py:build_optimizer`` builds it from
``training.optimizers.adafactor``, over 5 steps of the same gradients.

The leaves cover the layouts whose factored axes differ between flax and
torch: a 3D conv kernel (flax ``[k,k,k,in,out]``, torch
``[out,in,k,k,k]``), a transposed conv, a dense kernel, an attention's
q/k/v kernel (flax ``[H, heads, hd]``, one torch axis split in two) and an
``[E, 768, 3072]`` expert weight, factored; biases, norm affines and
``[E, F]`` expert biases unfactored. Cases: momentum null and 0.9, weight
decay under the no-decay mask, the learning rate changed mid-run,
``grad_accum`` 2 and ``multiply_by_parameter_scale``. Params within 1e-5
relative + 1e-7 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core import optim as joptim
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core import optim as toptim
from multimodal_tta_tpu_torch.models.convert import flax_layouts, from_flax
from multimodal_tta_tpu_torch.models.layers import LayerNorm, TransposedConvUp
from multimodal_tta_tpu_torch.models.moe import MoEMlp
from multimodal_tta_tpu_torch.models.vit import SelfAttention

torch.set_num_threads(2)

E = 2


class Leaves(nn.Module):
    """One module of each layout, under flax's names."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv3d(6, 8, 3)
        self.up = TransposedConvUp(8, 6, 2)
        self.dense = nn.Linear(10, 12)
        self.MultiHeadDotProductAttention_0 = SelfAttention(12, 2)
        self.LayerNorm_0 = LayerNorm(12)
        self.moe = MoEMlp(768, 3072, E)


def flax_tree(seed: int, scale: float = 1.0) -> dict:
    """A flax-layout tree of the ``Leaves`` params, from a numpy seed."""
    rng = np.random.RandomState(seed)
    shapes = {
        "conv": {"kernel": (3, 3, 3, 6, 8), "bias": (8,)},
        "up": {"up": {"kernel": (2, 2, 2, 8, 6), "bias": (6,)}},
        "dense": {"kernel": (10, 12), "bias": (12,)},
        "MultiHeadDotProductAttention_0": {
            **{p: {"kernel": (12, 2, 6), "bias": (2, 6)} for p in ("query", "key", "value")},
            "out": {"kernel": (2, 6, 12), "bias": (12,)}},
        "LayerNorm_0": {"scale": (12,), "bias": (12,)},
        "moe": {"router": {"kernel": (768, E), "bias": (E,)}, "wi": (E, 768, 3072), "bi": (E, 3072),
                "wo": (E, 3072, 768), "bo": (E, 768)},
    }

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return (scale * rng.randn(*node)).astype(np.float32)

    return fill(shapes)


CASES = {
    "momentum_null_decay": {"momentum": None, "weight_decay": 1e-2},
    "momentum_0.9_decay": {"momentum": 0.9, "weight_decay": 1e-2},
    "accum2_param_scale": {"momentum": None, "weight_decay": 0.0, "multiply_by_parameter_scale": True,
                           "_accum": 2},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adafactor_matches_optax(case):
    opts = dict(CASES[case])
    accum = opts.pop("_accum", 1)
    training = {"optimizer": "adafactor", "grad_accum": accum,
                "param_groups": {"no_decay_keys": ["bias", "norm", "scale"], "treat_1d_as_no_decay": True},
                "optimizers": {"adafactor": dict(opts, lr=1e-2, decay_rate=0.8, clipping_threshold=1.0,
                                                 min_dim_size_to_factor=6)}}
    params = flax_tree(0)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx, lr = joptim.build_optimizer(JaxConfigNode(training), jparams)
    jstate = tx.init(jparams)

    @jax.jit
    def jax_step(grads, jstate, jparams):
        updates, jstate = tx.update(grads, jstate, jparams)
        return jstate, optax.apply_updates(jparams, updates)
    model = Leaves()
    model.load_state_dict(from_flax(params), strict=True)
    opt, lr_t = toptim.build_optimizer(ConfigNode(training), model)
    assert lr_t == lr == 1e-2
    inner = getattr(opt, "optimizer", opt)
    assert isinstance(inner, toptim.Adafactor) and inner.eps == 1e-30
    names = dict(model.named_parameters())
    for step in range(5):
        if step == 3:  # the scheduler's per-epoch learning rate
            jstate = joptim.set_learning_rate(jstate, 3e-3)
            toptim.set_learning_rate(opt, 3e-3)
        grads = flax_tree(100 + step, scale=0.1)
        jstate, jparams = jax_step(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        for n, g in from_flax(grads).items():
            names[n].grad = g
        opt.step()
        want = from_flax(jax.tree_util.tree_map(np.asarray, jparams))
        for n, p in names.items():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{case}: {n} after step {step}")
    # the factored leaves keep row and column moments in flax's layout
    st = inner.state
    assert set(st[names["moe.wi"]]) >= {"v_row", "v_col"} and st[names["moe.wi"]]["v_row"].shape == (E, 768)
    assert st[names["conv.weight"]]["v_row"].shape == (3, 3, 3, 6)  # [k,k,k,in,out] without its largest axis
    assert "v" in st[names["conv.bias"]] and ("mu" in st[names["dense.weight"]]) == (opts["momentum"] is not None)


def test_factored_axes_follow_the_flax_layout():
    m = Leaves()
    lay = flax_layouts(m)
    assert lay["conv.weight"] == ((2, 3, 4, 1, 0), (3, 3, 3, 6, 8))
    assert lay["up.up.weight"] == ((2, 3, 4, 0, 1), (2, 2, 2, 8, 6))
    assert lay["dense.weight"] == ((1, 0), (10, 12))
    assert lay["MultiHeadDotProductAttention_0.query.weight"] == ((1, 0), (12, 2, 6))
    assert lay["MultiHeadDotProductAttention_0.query.bias"] == ((0,), (2, 6))
    assert lay["MultiHeadDotProductAttention_0.out.weight"] == ((1, 0), (2, 6, 12))
    assert lay["moe.wi"] == ((0, 1, 2), (E, 768, 3072))
    for n, p in m.named_parameters():  # the view is the flax leaf from_flax came from
        perm, shape = lay[n]
        assert p.permute(perm).reshape(shape).shape == shape
    assert toptim.factored_dims((3, 3, 3, 6, 8), 6) == (3, 4)
    assert toptim.factored_dims((12, 2, 6), 6) == (2, 0) and toptim.factored_dims((12, 2, 6), 128) is None
    state_bytes = lambda o: sum(t.numel() * t.element_size() for s in o.state.values() for t in s.values()  # noqa
                                if torch.is_tensor(t))
    adam = torch.optim.Adam(m.parameters())
    ada = toptim.Adafactor(m.parameters(), lr=1e-3, layouts={id(p): lay[n] for n, p in m.named_parameters()})
    for p in m.parameters():
        p.grad = torch.zeros_like(p)
    adam.step()
    ada.step()
    n_params = sum(p.numel() for p in m.parameters())
    assert state_bytes(adam) >= 8 * n_params and state_bytes(ada) < 0.01 * 4 * n_params
    # a resumed optimizer (state_dict -> load_state_dict) takes the next step bitwise as the live one
    twin = Leaves()
    twin.load_state_dict(m.state_dict())
    ada2 = toptim.Adafactor(twin.parameters(), lr=1e-3,
                            layouts={id(p): lay[n] for n, p in twin.named_parameters()})
    ada2.load_state_dict(ada.state_dict())
    for p, q in zip(m.parameters(), twin.parameters()):
        p.grad = torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
        q.grad = p.grad.clone()
    ada.step()
    ada2.step()
    assert all(torch.equal(p, q) for p, q in zip(m.parameters(), twin.parameters()))
