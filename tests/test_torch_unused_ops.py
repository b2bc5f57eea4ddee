"""Parity of the port's ops that nothing calls with the JAX ones, on the same
inputs, weights and random draws:

  - ``ops/augment.py:rand_rot90``: the JAX draws (rebuilt from its key in its
    split order) through ``apply_rand_rot90``, equal to the JAX output;
  - ``ops/losses.py:focal_loss`` / ``triplet_margin_loss``: values within
    1e-5 relative, gradients within 1e-5 relative of ``jax.grad`` (ties of
    the batch-hard maxima and of the margin's hinge included);
  - ``models/mogvae.py:VAEDeltaMoG`` (``vae_delta_mog``): the flax params
    through ``models/convert.py``, the JAX ``eps_post`` / ``eps_k`` handed
    over; ``delta`` and every ``aux`` entry within 1e-5 relative L2 in f32;
  - ``utils/logger.py:LoggerWriter`` and ``models/vit.py:get_vit_model``."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.ops import augment as jaug
from multimodal_tta_tpu.ops import losses as jlosses
from multimodal_tta_tpu.registry import get_model as jax_get_model
from multimodal_tta_tpu.utils.logger import LoggerWriter as JaxLoggerWriter
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.models.convert import from_flax
from multimodal_tta_tpu_torch.models.vit import ViT, get_vit_model
from multimodal_tta_tpu_torch.ops import augment as taug
from multimodal_tta_tpu_torch.ops import losses as tlosses
from multimodal_tta_tpu_torch.registry import get_model
from multimodal_tta_tpu_torch.utils.logger import LoggerWriter
from tests._torch_port import randomize

REL = 1e-5


def _jax_rot90_k(key, b, prob, max_k):
    """The reference's per-sample quarter turns, in its key-split order."""
    k1, k2 = jax.random.split(key)
    do = jax.random.uniform(k1, (b,)) < prob
    return np.asarray(jnp.where(do, jax.random.randint(k2, (b,), 1, max_k + 1), 0))


@pytest.mark.parametrize("prob,max_k", [(0.3, 3), (1.0, 3), (0.9, 5)])
def test_rand_rot90_matches_reference_with_its_draws(prob, max_k):
    rng = np.random.RandomState(0)
    image = rng.randn(6, 3, 5, 5, 2).astype(np.float32)
    label = (rng.rand(6, 3, 5, 5, 1) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want_img, want_lbl = jaug.rand_rot90(key, jnp.asarray(image), jnp.asarray(label), prob=prob, max_k=max_k)
    k = _jax_rot90_k(key, 6, prob, max_k)
    got_img, got_lbl = taug.apply_rand_rot90(torch.from_numpy(image), torch.from_numpy(label), torch.from_numpy(k.copy()))
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(want_lbl))


def test_rand_rot90_draws_and_square_plane():
    g = torch.Generator().manual_seed(0)
    k = taug.rot90_draws(4000, g, prob=0.3, max_k=3)
    assert k.dtype == torch.int64 and set(k.unique().tolist()) == {0, 1, 2, 3}
    assert abs(float((k > 0).float().mean()) - 0.3) < 0.03
    x = torch.arange(2 * 2 * 3 * 3, dtype=torch.float32).reshape(2, 1, 3, 3, 2)
    img, lbl = taug.rand_rot90(x, x[..., :1], torch.Generator().manual_seed(1), prob=1.0)
    assert img.shape == x.shape and torch.equal(img[..., :1], lbl)
    with pytest.raises(ValueError, match="square plane"):
        taug.rand_rot90(torch.zeros(1, 2, 3, 4, 1), torch.zeros(1, 2, 3, 4, 1), g)


def _value_and_grad(jfn, tfn, x, *rest):
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(x), *(jnp.asarray(r) for r in rest))
    xt = torch.from_numpy(x).requires_grad_()
    got = tfn(xt, *(torch.from_numpy(r) for r in rest))
    (got_g,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=REL)
    want_g = np.asarray(want_g)
    assert np.linalg.norm(got_g.numpy() - want_g) <= REL * max(np.linalg.norm(want_g), 1e-30)
    return float(got.detach()), got_g.numpy()


@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (0.5, 0.0), (0.8, 3.5)])
def test_focal_loss_matches_reference(alpha, gamma):
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 4, 6, 5, 1) * 4).astype(np.float32)
    target = (rng.rand(2, 4, 6, 5, 1) > 0.7).astype(np.float32)
    _value_and_grad(lambda x, t: jlosses.focal_loss(x, t, alpha, gamma),
                    lambda x, t: tlosses.focal_loss(x, t, alpha, gamma), logits, target)


TRIPLET_CASES = {
    "random": lambda rng: (rng.randn(12, 8).astype(np.float32), rng.randint(0, 3, 12).astype(np.int32)),
    # two equal distances to the hardest positive and to the hardest negative
    "ties": lambda rng: (np.array([[0, 0], [1, 0], [-1, 0], [0, 2], [0, -2], [3, 3]], np.float32),
                         np.array([0, 0, 0, 1, 1, 2], np.int32)),
    # anchors with no positive are not valid; duplicates sit at the 1e-12 floor
    "singletons_and_duplicates": lambda rng: (np.array([[0.5, 1], [0.5, 1], [2, 2], [4, 0], [1, 1]], np.float32),
                                              np.array([0, 0, 1, 2, 0], np.int32)),
    "hinge_at_zero": lambda rng: (np.array([[0, 0], [1, 0], [0, 1.3], [5, 5]], np.float32),
                                  np.array([0, 0, 1, 1], np.int32)),
}


@pytest.mark.parametrize("case", sorted(TRIPLET_CASES))
def test_triplet_margin_loss_matches_reference(case):
    emb, labels = TRIPLET_CASES[case](np.random.RandomState(2))
    _value_and_grad(lambda e, l: jlosses.triplet_margin_loss(e, l, 0.3),
                    lambda e, l: tlosses.triplet_margin_loss(e, l, 0.3), emb, labels)


def test_triplet_margin_loss_without_valid_anchors_is_zero():
    emb = torch.randn(3, 4, requires_grad=True)
    loss = tlosses.triplet_margin_loss(emb, torch.tensor([0, 1, 2]))
    assert float(loss.detach()) == 0.0
    assert torch.equal(torch.autograd.grad(loss, emb)[0], torch.zeros(3, 4))


MOG = {"in_channels": 3, "out_channels": 1, "latent_size": 16, "channels": [4, 8, 16, 32], "strides": [2, 2],
       "image_size": [32, 32], "mog": {"K": 4, "gate_hidden": 12}}


@pytest.mark.parametrize("use_gate", [False, True])
def test_vae_delta_mog_matches_reference(use_gate):
    cfg = {**MOG, "mog": {**MOG["mog"], "use_gate": use_gate}}
    jm = jax_get_model("vae_delta_mog").from_config(JaxConfigNode(cfg))
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    variables = jm.init({"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)}, jnp.asarray(x))
    params = randomize(jax.tree_util.tree_map(np.asarray, variables["params"]), seed=4)
    key = jax.random.PRNGKey(5)
    want_delta, want_aux = jm.apply({"params": params}, jnp.asarray(x), rng=key)
    k1, k2 = jax.random.split(key)  # the reference's draws, in its split order
    eps_post = np.array(jax.random.normal(k1, (2, 16)))
    eps_k = np.array(jax.random.normal(k2, (2, 4, 16)))

    tm = get_model("vae_delta_mog").from_config(ConfigNode(cfg), device="cpu", seed=None)
    tm.load_state_dict(from_flax(params), strict=True)
    with torch.no_grad():
        delta, aux = tm(torch.from_numpy(x), torch.from_numpy(eps_post), torch.from_numpy(eps_k))
    assert tuple(delta.shape) == (2, 32, 32, 1) and set(aux) == set(want_aux)
    for got, want in [(delta, want_delta)] + [(aux[k], want_aux[k]) for k in sorted(aux)]:
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.linalg.norm(got.numpy() - want) <= REL * np.linalg.norm(want), (got, want)


def test_vae_delta_mog_defaults_and_draws():
    """The registry default (channels 32..512, 64x64, K = 16) built on the
    CPU; without draws the forward takes them from a generator seeded 0, as
    the reference falls back to ``PRNGKey(0)``."""
    m = get_model("vae_delta_mog").from_config(ConfigNode({}), device="cpu", seed=0)
    assert (m.mog_k, m.latent_size, m.bottleneck) == (16, 128, (256, 4, 4))
    assert sorted(n for n, _ in m.named_children()) == sorted(
        ["enc0", "enc1", "enc2", "enc3", "mu", "logvar", "unflatten", "dec0", "dec1", "dec2", "dec3", "head"])
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, aux_a = m(x)
        b, _ = m(x, *m.reparam_draws(2, torch.Generator().manual_seed(0)))
        c, _ = m(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.allclose(aux_a["pi"].sum(-1), torch.ones(2))
    with pytest.raises(ValueError, match="bottleneck"):
        m(torch.zeros(1, 32, 32, 3))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_model("vae_delta_mog").from_config(ConfigNode({}))


def test_logger_writer_matches_reference():
    records = {"jax": [], "port": []}

    class Keep(logging.Handler):
        def __init__(self, side):
            super().__init__()
            self.side = side

        def emit(self, record):
            records[self.side].append((record.levelno, record.getMessage()))

    for side, cls in (("jax", JaxLoggerWriter), ("port", LoggerWriter)):
        logger = logging.getLogger(f"test_logger_writer_{side}")
        logger.propagate = False
        logger.setLevel(logging.DEBUG)
        logger.addHandler(Keep(side))
        w = cls(logger, logging.WARNING)
        for chunk in ("first line\nsecond ", "part\n\n   \nthird", " line  "):
            w.write(chunk)
        w.flush()
        w.flush()
    assert records["port"] == records["jax"] == [
        (logging.WARNING, "first line"), (logging.WARNING, "second part"), (logging.WARNING, "third line")]


def test_get_vit_model():
    m = get_vit_model("vit_b_16", num_classes=3, image_size=32, depth=1, hidden=32, heads=2, mlp_dim=64,
                      device="cpu", seed=0)
    assert isinstance(m, ViT) and m.variant == "vit_b_16" and m.head.out_features == 3
    with pytest.raises(ValueError, match="Unknown vit variant"):
        get_vit_model("vit_z_1", device="cpu")
