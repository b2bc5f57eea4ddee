"""Parity of the port's losses (multimodal_tta_tpu_torch/ops/losses.py) with
the JAX ones. ``entropy_loss``, the Tent objective: value, per-sample value
(the JAX Tent step's vmap) and gradient, in both focus modes.
``pseudo_label_loss``, the PL objective: the same, in both modes, and zero
loss and gradient where no voxel is confident.
``dice_ce_loss``, ``generalized_wasserstein_dice_loss`` / ``gwdl_ce_loss``
and the criterion factories: forward value, 1e-5 relative (f32 means over a
few hundred voxels in another order), and the gradient against
``jax.grad``, 1e-4 relative + 1e-9 absolute (the backward of those means)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.ops import losses as jlosses
from multimodal_tta_tpu.ops.losses import entropy_loss as jax_entropy_loss
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.ops import losses as tlosses
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


@pytest.mark.parametrize("sigmoid", [True, False], ids=["sigmoid", "softmax"])
@pytest.mark.parametrize("conf", [0.6, 0.9])
def test_pseudo_label_loss_value_per_sample_and_grad(sigmoid, conf):
    x = _logits(sigmoid, seed=2)
    jfn = lambda l: jlosses.pseudo_label_loss(l, sigmoid=sigmoid, conf_threshold=conf)  # noqa: E731
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tlosses.pseudo_label_loss(xt, sigmoid=sigmoid, conf_threshold=conf)
    (got_g,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-9)
    want_ps = jax.vmap(lambda l: jfn(l[None]))(jnp.asarray(x))
    got_ps = tlosses.pseudo_label_loss(torch.from_numpy(x), sigmoid=sigmoid, conf_threshold=conf, per_sample=True)
    assert tuple(got_ps.shape) == (x.shape[0],)
    np.testing.assert_allclose(got_ps.numpy(), np.asarray(want_ps), rtol=1e-5)


def test_pseudo_label_loss_abstains_without_confident_voxels():
    xt = torch.zeros(2, 3, 3, 3, 1, requires_grad=True)  # p = 0.5 everywhere
    loss = tlosses.pseudo_label_loss(xt, conf_threshold=0.9)
    (g,) = torch.autograd.grad(loss, xt)
    assert float(loss.detach()) == 0.0 and not bool(g.any())


def test_unknown_focus_raises():
    with pytest.raises(ValueError):
        entropy_loss(torch.zeros(1, 2, 2, 2, 1), focus="most")


def _seg_inputs(channels, seed=2):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(2, 4, 5, 6, channels) * 2).astype(np.float32)
    onehot = (rng.rand(2, 4, 5, 6, channels) > 0.6).astype(np.float32)
    idx = rng.randint(0, channels, size=(2, 4, 5, 6)).astype(np.int32)
    return logits, onehot, idx


DICE_CE_CASES = {
    "sigmoid": dict(sigmoid=True),
    "sigmoid_weighted": dict(sigmoid=True, ce_weight=[0.5, 2.0, 1.0], lambda_dice=0.7, lambda_ce=1.3),
    "sigmoid_sq_jaccard_nobg": dict(sigmoid=True, squared_pred=True, jaccard=True, include_background=False),
    "softmax_index": dict(sigmoid=False, softmax=True, to_onehot_y=True),
    "softmax_index_weighted": dict(sigmoid=False, softmax=True, to_onehot_y=True,
                                   ce_weight=[0.2, 1.0, 3.0], include_background=False),
    "softmax_onehot": dict(sigmoid=False, softmax=True),
}


@pytest.mark.parametrize("case", sorted(DICE_CE_CASES))
def test_dice_ce_loss(case):
    kw = DICE_CE_CASES[case]
    logits, onehot, idx = _seg_inputs(3)
    if case.startswith("softmax_index"):
        target = idx
    elif case == "softmax_onehot":
        target = np.eye(3, dtype=np.float32)[idx]
    else:
        target = onehot
    want = jlosses.dice_ce_loss(jnp.asarray(logits), jnp.asarray(target), **kw)
    got = tlosses.dice_ce_loss(torch.from_numpy(logits), torch.from_numpy(target), **kw)
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_loss_terms():
    logits, onehot, idx = _seg_inputs(3, seed=3)
    lt, ot, it = torch.from_numpy(logits), torch.from_numpy(onehot), torch.from_numpy(idx).long()
    w = [0.5, 2.0, 1.0]
    pairs = [
        (tlosses.soft_dice_loss(torch.sigmoid(lt), ot),
         jlosses.soft_dice_loss(jnp.asarray(1 / (1 + np.exp(-logits))), jnp.asarray(onehot))),
        (tlosses.binary_cross_entropy_with_logits(lt, ot, pos_weight=torch.tensor(w)),
         jlosses.binary_cross_entropy_with_logits(jnp.asarray(logits), jnp.asarray(onehot), jnp.asarray(w))),
        (tlosses.softmax_cross_entropy(lt, it, class_weight=torch.tensor(w)),
         jlosses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(idx), jnp.asarray(w))),
        (tlosses.softmax_cross_entropy(lt, it), jlosses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(idx))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the written-out BCE is torch's own
    np.testing.assert_allclose(
        float(tlosses.binary_cross_entropy_with_logits(lt, ot, pos_weight=torch.tensor(w))),
        float(torch.nn.BCEWithLogitsLoss(pos_weight=torch.tensor(w))(lt, ot)), rtol=1e-6)


@pytest.mark.parametrize("crit", [
    {}, {"sigmoid": True, "weight": [2.0], "lambda_dice": 0.5, "jaccard": True},
    {"name": "dice_ce", "softmax": True, "ce_weight": [1.0, 2.0, 0.5]},
])
def test_make_criterion(crit):
    softmax = bool(crit.get("softmax"))
    logits, onehot, idx = _seg_inputs(3 if softmax else 1, seed=4)
    target = idx if softmax else onehot
    want = jlosses.make_criterion(JaxConfigNode(crit))(jnp.asarray(logits), jnp.asarray(target))
    for cfg in (ConfigNode(crit), crit):
        got = tlosses.make_criterion(cfg)(torch.from_numpy(logits), torch.from_numpy(target))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_criterion_errors():
    with pytest.raises(ValueError, match="distance_matrix is required"):
        tlosses.make_criterion(ConfigNode({"name": "gwdl", "softmax": True}))
    with pytest.raises(ValueError, match="softmax label-map"):
        tlosses.make_criterion(ConfigNode({"name": "gwdl", "sigmoid": True}))
    with pytest.raises(ValueError, match="zero diagonal"):
        tlosses.make_criterion(ConfigNode({"name": "gwdl", "softmax": True,
                                           "distance_matrix": [[0.0, 1.0], [1.0, 0.5]]}))
    with pytest.raises(ValueError, match="unknown criterion"):
        tlosses.make_criterion(ConfigNode({"name": "focal"}))
    with pytest.raises(ValueError):
        tlosses.make_dice_ce_loss(ConfigNode({"softmax": True, "sigmoid": True}))
    with pytest.raises(ValueError):
        tlosses.make_dice_ce_loss(ConfigNode({"softmax": False, "sigmoid": False}))
    x = torch.zeros(1, 2, 2, 2, 2)
    with pytest.raises(ValueError):
        tlosses.dice_ce_loss(x, x, sigmoid=True, softmax=True)
    with pytest.raises(ValueError):
        tlosses.dice_ce_loss(x, x, sigmoid=False, softmax=False)
    with pytest.raises(ValueError, match="ndim"):
        tlosses.dice_ce_loss(x, torch.zeros(1, 2), sigmoid=False, softmax=True)
    with pytest.raises(ValueError, match="3x3 but logits have 2"):
        tlosses.generalized_wasserstein_dice_loss(x, torch.zeros(1, 2, 2, 2), np.ones((3, 3)) - np.eye(3))


def _grad_pair(jax_fn, torch_fn, logits, target):
    want, want_g = jax.value_and_grad(lambda l: jax_fn(l, jnp.asarray(target)))(jnp.asarray(logits))
    xt = torch.from_numpy(logits).requires_grad_()
    got = torch_fn(xt, torch.from_numpy(target))
    (got_g,) = torch.autograd.grad(got, xt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("case", sorted(DICE_CE_CASES))
def test_dice_ce_loss_gradient(case):
    """The training objective's gradient, sigmoid multilabel with ``ce_weight``
    and softmax, against ``jax.grad``."""
    kw = DICE_CE_CASES[case]
    logits, onehot, idx = _seg_inputs(3, seed=5)
    target = idx if case.startswith("softmax_index") else (
        np.eye(3, dtype=np.float32)[idx] if case == "softmax_onehot" else onehot)
    _grad_pair(lambda l, t: jlosses.dice_ce_loss(l, t, **kw),
               lambda l, t: tlosses.dice_ce_loss(l, t, **kw), logits, target)


def test_hecktor21_criterion_gradient():
    """The recipe's criterion: sigmoid, lambda_dice 5, ce_weight [50], one channel."""
    crit = {"sigmoid": True, "lambda_dice": 5.0, "lambda_ce": 1.0, "ce_weight": [50.0],
            "include_background": False}
    logits, onehot, _ = _seg_inputs(1, seed=6)
    _grad_pair(jlosses.make_criterion(JaxConfigNode(crit)), tlosses.make_criterion(ConfigNode(crit)),
               logits, onehot)


GWDL_CASES = {
    "uniform": {"distance_matrix": (np.ones((3, 3)) - np.eye(3)).tolist()},
    "tree_ce": {"distance_matrix": [[0.0, 1.0, 1.0], [1.0, 0.0, 0.5], [1.0, 0.5, 0.0]], "lambda_ce": 1.0,
                "ce_weight": [1.0, 2.0, 4.0]},
    "background_1": {"distance_matrix": [[0.0, 0.7, 1.0], [0.7, 0.0, 0.3], [1.0, 0.3, 0.0]],
                     "background_index": 1, "lambda_ce": 0.5},
}


@pytest.mark.parametrize("case", sorted(GWDL_CASES))
def test_gwdl_value_and_gradient(case):
    crit = dict(GWDL_CASES[case], name="gwdl", softmax=True)
    logits, _, idx = _seg_inputs(3, seed=7)
    _grad_pair(jlosses.make_criterion(JaxConfigNode(crit)), tlosses.make_criterion(ConfigNode(crit)),
               logits, idx)


def test_criterion_builds_its_constants_once_per_device(monkeypatch):
    """A loss called once per sample reuses one ``ce_weight`` / distance-matrix
    tensor per device and dtype instead of copying it in every call."""
    table = tlosses._Constant([50.0])
    x = torch.zeros(1, 2, 2, 2, 1)
    assert table.on(x) is table.on(x)
    assert table.on(x, torch.float64) is not table.on(x)
    assert table.on(x, torch.float64).dtype == torch.float64
    built = []
    real = torch.tensor

    def counting_tensor(*args, **kwargs):
        built.append(args)
        return real(*args, **kwargs)

    crits = [{"sigmoid": True, "ce_weight": [50.0]},
             dict(GWDL_CASES["tree_ce"], name="gwdl", softmax=True)]
    for crit in crits:
        fn = tlosses.make_criterion(ConfigNode(crit))
        logits, onehot, idx = _seg_inputs(1 if crit.get("sigmoid") else 3, seed=8)
        target = torch.from_numpy(onehot if crit.get("sigmoid") else idx)
        built.clear()
        monkeypatch.setattr(torch, "tensor", counting_tensor)
        first = [float(fn(torch.from_numpy(logits), target)) for _ in range(3)]
        monkeypatch.undo()
        assert len(built) == (1 if crit.get("sigmoid") else 2), built  # at the first call only
        assert first[0] == first[1] == first[2]
