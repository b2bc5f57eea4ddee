"""The slice end to end: the port's Tent adapt+segment serving step
(multimodal_tta_tpu_torch/tta/tent.py) against the JAX TentAdapter on the
same dryrun UNet3D weights, with the HECKTOR on-device transform.

Tolerances: adapted-minus-source norm deltas agree to a relative norm of
1e-3, entropies to 1e-5 relative, uint8 predictions on >= 99.9% of voxels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core.train_state import TrainState
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu.tta.tent import TentAdapter as JaxTentAdapter
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.models.convert import unet3d_from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.registry import get_tta_method
from multimodal_tta_tpu_torch.tta.tent import TentAdapter, flax_path, norm_param_mask
from tests._torch_port import DEVICE_TRANSFORM, DRYRUN, load_flax, np_params, randomize

torch.set_num_threads(1)

THRESHOLD = 0.3


def _cfg(**tta):
    base = {"method": "tent", "steps": 1, "lr": 1e-3, "optimizer": "sgd", "momentum": 0.9,
            "update": "norm", "episodic": True}
    base.update(tta)
    return {"task": {"seed": 0}, "training": {"criterion": {"sigmoid": True}}, "tta": base}


def _params(seed=0):
    x0 = np.zeros((1, 16, 16, 16, 2), np.float32)
    return randomize(np_params(JaxUNet3D(**DRYRUN), x0, train=False), seed)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(2, 16, 16, 16, 2) * 100).astype(np.float32) for _ in range(n)]


def _run_jax(params, cfg_dict, batches, n_valid, mode):
    cfg = JaxConfigNode(cfg_dict)
    jm = JaxUNet3D(**DRYRUN)
    state = TrainState.create(apply_fn=jm.apply, params=jax.tree_util.tree_map(jnp.asarray, params),
                              tx=optax.identity())
    adapter = JaxTentAdapter(cfg.tta, config=cfg, mesh=None, device_transform=DEVICE_TRANSFORM)
    step = adapter.make_adapt_predict_fn(state, threshold=THRESHOLD, predict_mode=mode)
    cur, ents, preds = state, [], []
    for x in batches:
        cur, pred = step(cur, jnp.asarray(x), n_valid)
        ents.append(adapter.last_entropy)
        preds.append(np.asarray(pred))
    adapted = unet3d_from_flax(jax.tree_util.tree_map(np.asarray, cur.params))
    return adapted, ents, preds


def _run_torch(params, cfg_dict, batches, n_valid, mode):
    cfg = ConfigNode(cfg_dict)
    model = load_flax(UNet3D(**DRYRUN, device="cpu"), params)
    adapter = TentAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device="cpu")
    step = adapter.make_adapt_predict_fn(model, threshold=THRESHOLD, predict_mode=mode)
    ents, preds = [], []
    for x in batches:
        state, pred = step(model, torch.from_numpy(x), n_valid)
        assert state is model and pred.dtype == torch.uint8
        ents.append(adapter.last_entropy)
        preds.append(pred.numpy())
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, ents, preds, model


def _compare(params, cfg_dict, batches, n_valid, mode):
    j_adapted, j_ents, j_preds = _run_jax(params, cfg_dict, batches, n_valid, mode)
    t_adapted, t_ents, t_preds, model = _run_torch(params, cfg_dict, batches, n_valid, mode)
    source = unet3d_from_flax(params)
    norm = [n for n, m in norm_param_mask(model).items() if m]
    assert len(norm) == 36
    dj = torch.cat([(j_adapted[n] - source[n]).flatten() for n in norm])
    dt = torch.cat([(t_adapted[n] - source[n]).flatten() for n in norm])
    assert float(dj.norm()) > 0
    assert float((dt - dj).norm() / dj.norm()) < 1e-3
    for n in t_adapted:  # frozen params stay at their source values
        if n not in norm:
            assert torch.equal(t_adapted[n], source[n]), n
    np.testing.assert_allclose(t_ents, j_ents, rtol=1e-5)
    for a, b in zip(t_preds, j_preds):
        assert a.shape == b.shape == (2, 16, 16, 16, 1)
        assert (a == b).mean() >= 0.999


def test_episodic_post_one_batch_masked_sample():
    """Strict serving: reset, one step, post-update forward. n_valid=1 of 2:
    the padding sample must not enter the objective."""
    _compare(_params(1), _cfg(episodic=True), _batches(1, seed=3), n_valid=1, mode="post")


def test_continual_inline_two_batches_carries_momentum():
    """Online serving: predictions from the adaptation forward, params and
    SGD momentum carried from batch 1 to batch 2."""
    _compare(_params(2), _cfg(episodic=False), _batches(2, seed=4), n_valid=2, mode="inline")


def test_update_path_regex_selects_the_same_tensors():
    params = _params(0)
    j = JaxTentAdapter(JaxConfigNode(_cfg(update_path_regex="^(dec0|up0)")["tta"]), mesh=None)
    jmask = j._param_mask(jax.tree_util.tree_map(jnp.asarray, params))
    want = {"/".join(str(k.key) for k in path)
            for path, v in jax.tree_util.tree_flatten_with_path(jmask)[0] if v}
    t = TentAdapter(ConfigNode(_cfg(update_path_regex="^(dec0|up0)")["tta"]), device="cpu")
    model = UNet3D(**DRYRUN, device="cpu")
    got = {flax_path(n) for n, m in t._param_mask(model).items() if m}
    assert got == want and len(got) == 4  # dec0.unit{0,1}.n.norm.{scale,bias}
    t_all = TentAdapter(ConfigNode(_cfg(update="all", update_path_regex="^up0")["tta"]), device="cpu")
    assert {flax_path(n) for n, m in t_all._param_mask(model).items() if m} == {
        "up0/up/kernel", "up0/up/bias"}


def test_adapted_set_is_frozen_elsewhere():
    model = UNet3D(**DRYRUN, device="cpu")
    cfg = ConfigNode(_cfg())
    TentAdapter(cfg.tta, config=cfg, device="cpu").make_adapt_fn(model)
    grads = {n: p.requires_grad for n, p in model.named_parameters()}
    assert sum(grads.values()) == 36
    assert all(grads[n] == m for n, m in norm_param_mask(model).items())


def _optax_vs_torch(tx, make_opt):
    rng = np.random.RandomState(5)
    p0 = [rng.randn(7).astype(np.float32), rng.randn(3).astype(np.float32)]
    grads = [[rng.randn(*a.shape).astype(np.float32) for a in p0] for _ in range(4)]
    jp = [jnp.asarray(a) for a in p0]
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = make_opt(tp)
    for g in grads:
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_sgd_momentum_is_the_optax_trace():
    _optax_vs_torch(optax.sgd(1e-2, momentum=0.9),
                    lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9, dampening=0.0))


def test_adam_matches_optax():
    _optax_vs_torch(optax.adam(1e-2), lambda ps: torch.optim.Adam(ps, lr=1e-2))


def test_adapter_builds_the_configured_optimizer():
    for name, cls in (("sgd", torch.optim.SGD), ("adam", torch.optim.Adam)):
        cfg = ConfigNode(_cfg(optimizer=name))
        ad = TentAdapter(cfg.tta, config=cfg, device="cpu")
        ad.make_adapt_fn(UNet3D(**DRYRUN, device="cpu"))
        assert isinstance(ad._opt, cls)


def test_episodic_resets_per_batch_and_make_adapt_fn():
    model = UNet3D(**DRYRUN, device="cpu", seed=1)
    cfg = ConfigNode(_cfg(episodic=True, steps=2, lr=1e-2))
    ad = TentAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device="cpu")
    adapt = ad.make_adapt_fn(model)
    assert ad.last_entropy is None
    x = torch.from_numpy(_batches(1, seed=6)[0])
    first = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert adapt(model, x, 2) is model
    once = {n: p.detach().clone() for n, p in model.named_parameters()}
    adapt(model, x, 2)
    assert all(torch.equal(once[n], p) for n, p in model.named_parameters())
    assert any(not torch.equal(once[n], first[n]) for n in first)
    assert len(ad._last_ents) == 2 and np.isfinite(ad.last_entropy)


def test_inline_steps1_episodic_predicts_the_source_forward():
    model = UNet3D(**DRYRUN, device="cpu", seed=2)
    x = torch.from_numpy(_batches(1, seed=7)[0])
    with torch.no_grad():
        want = (torch.sigmoid(model(x)) >= 0.5).to(torch.uint8)
    cfg = ConfigNode(_cfg(episodic=True))
    step = TentAdapter(cfg.tta, config=cfg, device="cpu").make_adapt_predict_fn(model, 0.5, "inline")
    _, pred = step(model, x, 2)
    assert torch.equal(pred, want)


def test_state_must_be_the_bound_model():
    cfg = ConfigNode(_cfg())
    step = TentAdapter(cfg.tta, config=cfg, device="cpu").make_adapt_predict_fn(
        UNet3D(**DRYRUN, device="cpu"), THRESHOLD)
    other = UNet3D(**DRYRUN, device="cpu")
    with pytest.raises(ValueError, match="state"):
        step(other, torch.zeros(1, 16, 16, 16, 2), 1)


@pytest.mark.parametrize("tta", [
    {"modality_dropout": {"enabled": True}}, {"window": {"enabled": True}},
    {"early_stop": {"enabled": True}}, {"restore": {"enabled": True}},
    {"reliability": {"enabled": True}}, {"fisher": {"enabled": True}},
    {"loss": "entropy+consistency"}, {"loss": "pl"},
])
def test_unported_extras_raise(tta):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TentAdapter(ConfigNode(_cfg(**tta)["tta"]), device="cpu")


@pytest.mark.parametrize("tta", [{"loss": "mystery"}, {"predict": "nope"},
                                 {"entropy_focus": "most"}, {"sync_over_mesh": False}])
def test_bad_config_raises(tta):
    with pytest.raises(ValueError):
        TentAdapter(ConfigNode(_cfg(**tta)["tta"]), device="cpu")


def test_registry_and_cuda_default(monkeypatch):
    assert get_tta_method("tent") is TentAdapter
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TentAdapter(ConfigNode(_cfg()["tta"]))


def test_softmax_mode_predicts_the_argmax():
    cfg = ConfigNode({"training": {"criterion": {"softmax": True}}, "tta": _cfg()["tta"]})
    ad = TentAdapter(cfg.tta, config=cfg, device="cpu")
    assert not ad.sigmoid_mode
    logits = torch.from_numpy(np.random.RandomState(8).randn(2, 3, 4, 5, 3).astype(np.float32))
    pred = ad._predict(logits, THRESHOLD)
    assert pred.dtype == torch.uint8 and tuple(pred.shape) == (2, 3, 4, 5, 1)
    assert torch.equal(pred[..., 0].long(), logits.argmax(-1))
