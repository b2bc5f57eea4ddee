"""Parity of the port's Mixture-of-Experts (``models/moe.py``, the MoE
branch of ``models/vit.py:EncoderBlock``, ``UNETR(moe_experts=...)`` and the
UNet3D bottleneck) with the flax modules, on the same params
(``models/convert.py:from_flax``) and seeded numpy inputs.

Tolerances, in f32:
  - ``MoEMlp``: dispatch (as the reference's einsum receives it) equal,
    combine within 1e-6 relative (it holds the gates: f32 softmaxes that
    round apart by an ulp); the output within 1e-5 relative L2; the aux loss within
    1e-6; the dropped share exact. Top-1 and top-2 at capacity factors 0.5
    (drops), 1.25 and 4, with a token on which every expert ties;
  - the MoE ``EncoderBlock`` and the models' forwards: max abs 1e-5 / 1e-4,
    every sown aux within 1e-6;
  - ``SegTrainer`` steps with the aux loss (SGD with momentum and weight
    decay, remat off and on): the
    losses and params to ``tests/test_torch_seg_trainer.py``'s tolerances.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.models.moe import MoEMlp as JaxMoE
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu.models.unetr import UNETR as JaxUNETR
from multimodal_tta_tpu.models.vit import EncoderBlock as JaxBlock
from multimodal_tta_tpu.tta.tent import norm_param_mask as jax_norm_param_mask
from multimodal_tta_tpu_torch.models import UNETR
from multimodal_tta_tpu_torch.models import moe as tmoe
from multimodal_tta_tpu_torch.models.convert import flax_path, from_flax
from multimodal_tta_tpu_torch.models.layers import capture_intermediates
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.models.vit import EncoderBlock
from multimodal_tta_tpu_torch.tta.tent import norm_param_mask
from tests._torch_port import (SGD, SMALL, SMALL_SHAPE, flat_flax, random_flax_params, trainer_config,
                               trainer_pair, assert_steps_match)
from tests.test_torch_seg_trainer import make_volumes

torch.set_num_threads(2)

H, F_, E = 8, 16, 4


def _tokens(b=2, n=12, seed=0):
    x = np.random.RandomState(seed).randn(b, n, H).astype(np.float32)
    x[0, 3] = 0.0  # with a zero router bias, every expert ties on this token
    return x


def _moe_params(k: int, seed: int):
    p = random_flax_params(JaxMoE(hidden=H, mlp_dim=F_, num_experts=E, k=k), (2, 12, H), seed)
    p["router"]["bias"] = np.zeros_like(p["router"]["bias"])
    return p


def _recording(einsum, keep: dict, name_of: dict):
    def rec(spec, *ops, **kw):
        if spec in name_of:
            keep[name_of[spec]] = np.asarray(ops[0], dtype=np.float32)
        return einsum(spec, *ops, **kw)
    return rec


DISPATCH_SPECS = {"bnec,bnh->ebch": "dispatch", "bnec,ebch->bnh": "combine"}


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_moe_mlp_matches_reference(k, cf):
    x = _tokens(seed=k)
    params = _moe_params(k, seed=10 * k)
    jm = JaxMoE(hidden=H, mlp_dim=F_, num_experts=E, k=k, capacity_factor=cf)
    jkeep, tkeep = {}, {}
    with mock.patch.object(jnp, "einsum", _recording(jnp.einsum, jkeep, DISPATCH_SPECS)):
        want, inter = jm.apply({"params": params}, jnp.asarray(x), mutable=["intermediates"])
    tm = tmoe.MoEMlp(H, F_, E, k, cf)
    tm.load_state_dict(from_flax(params), strict=True)
    with mock.patch.object(torch, "einsum", _recording(torch.einsum, tkeep, DISPATCH_SPECS)), \
            capture_intermediates() as got_inter, torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_array_equal(tkeep["dispatch"], jkeep["dispatch"])
    np.testing.assert_allclose(tkeep["combine"], jkeep["combine"], rtol=1e-6, atol=0)
    assert np.array_equal(tkeep["combine"] != 0, jkeep["combine"] != 0)
    # the tied token goes to expert 0 (and 1 for k=2), as jax.lax.top_k orders ties
    assert tkeep["dispatch"][0, 3, 0].sum() == 1.0 and tkeep["dispatch"][0, 3, 2:].sum() == 0.0
    want = np.asarray(want)
    assert np.linalg.norm(got.numpy() - want) <= 1e-5 * np.linalg.norm(want)
    j_inter = inter["intermediates"]
    np.testing.assert_allclose(float(got_inter["moe_aux"][0]), float(j_inter["moe_aux"][0]), atol=1e-6)
    assert float(got_inter["moe_dropped"][0]) == float(j_inter["moe_dropped"][0])
    if cf == 0.5:
        assert float(got_inter["moe_dropped"][0]) > 0.0
    assert tmoe.capacity(12, E, k, cf) == int(tkeep["dispatch"].shape[-1])


def test_route_takes_the_first_maximum():
    g = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4], [0.5, 0.2, 0.3, 0.0]])
    for k in (1, 2):
        top_g, top_i = tmoe.route(g, k)
        want_g, want_i = jax.lax.top_k(jnp.asarray(g.numpy()), k)
        np.testing.assert_array_equal(top_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(top_g.numpy(), np.asarray(want_g))


def test_moe_errors_and_init():
    with pytest.raises(ValueError, match="top-1/top-2"):
        tmoe.MoEMlp(H, F_, E, k=3)
    with pytest.raises(ValueError, match=">= 2 experts"):
        tmoe.MoEMlp(H, F_, 1)
    m = UNet3D(**SMALL, moe_experts=E, device="cpu", seed=3)
    wi = m.moe_bottleneck.wi.detach()
    # lecun truncated normal over (in, out), the expert axis a batch axis: sd 1/sqrt(in), cut at 2 sd
    assert abs(float(wi.std()) - 16 ** -0.5) < 0.02 and float(wi.abs().max()) <= 2 * 16 ** -0.5 / 0.8796 + 1e-6
    assert float(m.moe_bottleneck.bi.detach().abs().max()) == 0.0


def test_encoder_block_matches_reference():
    x = np.random.RandomState(3).randn(2, 10, 16).astype(np.float32)
    jb = JaxBlock(16, 2, 32, num_experts=E, moe_k=2, moe_capacity_factor=1.25)
    params = random_flax_params(jb, (2, 10, 16), seed=4)
    assert set(params) == {"LayerNorm_0", "MultiHeadDotProductAttention_0", "LayerNorm_1", "moe"}
    want, inter = jb.apply({"params": params}, jnp.asarray(x), mutable=["intermediates"])
    tb = EncoderBlock(16, 2, 32, num_experts=E, moe_k=2, moe_capacity_factor=1.25)
    tb.load_state_dict(from_flax(params), strict=True)
    assert {flax_path(n) for n, _ in tb.named_parameters()} == set(flat_flax(params))
    with capture_intermediates() as got_inter, torch.no_grad():
        got = tb(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(got_inter["moe_aux"][0]), float(inter["intermediates"]["moe"]["moe_aux"][0]),
                               atol=1e-6)


UNETR_MOE = dict(in_channels=2, num_classes=1, patch_size=4, hidden_size=16, mlp_dim=32, num_heads=2, num_layers=4,
                 feature_size=4, moe_experts=E, moe_every=2)
UNET_MOE = dict(SMALL, moe_experts=E, moe_k=2)


def _models(name: str, remat):
    if name == "unetr":
        return (JaxUNETR(**UNETR_MOE, remat=remat),
                UNETR(**UNETR_MOE, remat=remat, image_size=SMALL_SHAPE[:3], device="cpu"))
    return JaxUNet3D(**UNET_MOE, remat=remat), UNet3D(**UNET_MOE, remat=remat, device="cpu")


@pytest.mark.parametrize("name", ["unetr", "unet"])
def test_model_forward_and_tent_mask(name):
    jm, tm = _models(name, False)
    params = random_flax_params(jm, (1,) + SMALL_SHAPE, seed=6)
    tm.load_state_dict(from_flax(params), strict=True)
    assert {flax_path(n) for n, _ in tm.named_parameters()} == set(flat_flax(params))
    x = np.random.RandomState(7).randn(2, *SMALL_SHAPE).astype(np.float32)
    want, inter = jm.apply({"params": params}, jnp.asarray(x), train=True, mutable=["intermediates"])
    tm.train()
    with capture_intermediates() as got_inter, torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    want_aux = [v for p, v in flat_flax(inter["intermediates"]).items() if p.split("/")[-2] == "moe_aux"]
    assert len(got_inter["moe_aux"]) == len(want_aux) == (2 if name == "unetr" else 1)
    np.testing.assert_allclose([float(a) for a in got_inter["moe_aux"]], [float(a) for a in want_aux], atol=1e-6)
    # Tent adapts the same norm tensors (the MoE LayerNorms among them) as the reference selects
    n_jax = sum(jax.tree_util.tree_leaves(jax_norm_param_mask(params)))
    assert sum(norm_param_mask(tm).values()) == n_jax


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ["unetr", "unet"])
def test_segtrainer_steps_with_the_aux_loss(name, remat):
    """Two SGD steps with ``model.moe_aux_weight`` 0.01 (the Switch
    default): losses and params as the reference's, remat off and on (the
    recompute of a rematerialized MoE block sows nothing twice)."""
    jm, tm = _models(name, remat)
    params = random_flax_params(jm, (1,) + SMALL_SHAPE, seed=8)
    cfg = trainer_config(SGD, {"moe_experts": E, "moe_aux_weight": 0.01})
    jt, pt = trainer_pair(cfg, jm, tm, params)
    img, lbl = make_volumes(4, seed=12)
    batches = [{"image": img[i:i + 2], "label": lbl[i:i + 2]} for i in (0, 2)]
    losses = assert_steps_match(jt, pt, batches, f"{name} remat={remat}")
    assert np.isfinite(losses).all()
    stats = pt.moe_stats
    assert stats["aux"].shape == stats["dropped"].shape == ((2,) if name == "unetr" else (1,))
    assert not stats["aux"].requires_grad and float(stats["aux"].min()) > 0.0


@pytest.mark.parametrize("name", ["unetr", "unet_ds"])
def test_weight_bridge_round_trip_is_exact(name):
    """flax tree -> ``from_flax`` -> the port model -> back to the flax
    layout (``flax_path`` for the path, ``flax_layouts`` for the layout, the
    spatial flip of a transposed conv undone): every leaf bitwise, the
    router, the experts' [E, in, out] kernels, ``moe_ln``, the MoE block's
    ``LayerNorm_1`` and the ``ds_head{i}`` convs among them."""
    from multimodal_tta_tpu_torch.models.convert import flax_layouts

    if name == "unetr":
        jm, tm = _models("unetr", False)
    else:
        kw = dict(in_channels=2, num_classes=1, channels=(4, 8, 16, 32), strides=(2, 2, 2), num_res_units=1,
                  deep_supervision=2, moe_experts=E)
        jm, tm = JaxUNet3D(**kw), UNet3D(**kw, device="cpu")
    params = random_flax_params(jm, (1,) + SMALL_SHAPE, seed=9)
    tm.load_state_dict(from_flax(params), strict=True)
    flat, lay = flat_flax(params), flax_layouts(tm)
    for n, p in tm.named_parameters():
        perm, shape = lay[n]
        back = p.detach().permute(perm).reshape(shape)
        if n.endswith(".up.weight"):
            back = back.flip((0, 1, 2))
        assert np.array_equal(back.numpy(), flat[flax_path(n)]), n
    assert len(flat) == len(lay)
