"""Parity of the port's optimizers and schedules
(multimodal_tta_tpu_torch/core/optim.py) with the JAX reference
(multimodal_tta_tpu/core/optim.py): the no-decay mask tensor for tensor
through the converter's names, three updates of sgd/adam/adamw against the
optax chain of ``build_optimizer`` on the same params and gradients (f32:
rtol 1e-6, atol 1e-7 — the same arithmetic in another order, a few ulps of
the update; for the Adam family plus ``lr * 2^-23 / (1 - b2)`` per update:
optax takes the bias correction ``1 - b2^t`` in f32, where the cancellation
costs up to 2^-24 / (1 - b2^t) relative, torch takes it in f64),
``grad_accum`` against ``optax.MultiSteps`` with the same tolerance, and ``EpochScheduler`` for every name over all epochs, exactly
(plain Python on both sides)."""

import jax
import numpy as np
import optax
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core import optim as joptim
from multimodal_tta_tpu.core.train_state import param_count as jax_param_count
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core import optim as toptim
from multimodal_tta_tpu_torch.core.train_state import TrainState, param_count
from multimodal_tta_tpu_torch.models.convert import flax_path, unet3d_from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D

from _torch_port import SMALL, SMALL_SHAPE, flat_flax, load_flax, random_flax_params

torch.set_num_threads(1)

UPDATE_RTOL, UPDATE_ATOL = 1e-6, 1e-7
NO_DECAY = {"no_decay_keys": ["bias", "bn", "norm", "scale"], "treat_1d_as_no_decay": True}


@pytest.fixture(scope="module")
def flax_params():
    return random_flax_params(JaxUNet3D(**SMALL, dtype=jax.numpy.float32), (1,) + SMALL_SHAPE, seed=1)


def port_model(params):
    return load_flax(UNet3D(**SMALL, dtype=torch.float32, device="cpu"), params)


@pytest.mark.parametrize("keys,treat_1d", [(NO_DECAY["no_decay_keys"], True), (["norm"], False),
                                           ([], True), (["conv"], False)])
def test_no_decay_mask_matches_reference(flax_params, keys, treat_1d):
    want = flat_flax(joptim.no_decay_mask(flax_params, keys, treat_1d))
    model = port_model(flax_params)
    got = toptim.no_decay_mask(model, keys, treat_1d)
    assert {flax_path(n) for n in got} == set(want)
    assert {flax_path(n): v for n, v in got.items()} == {k: bool(v) for k, v in want.items()}


def test_flagship_mask_and_param_count_match_reference():
    """At full width (channels 32..512, shapes only on the JAX side): 82
    tensors, the same count of params, the same decay mask."""
    flagship = dict(in_channels=2, num_classes=1, channels=(32, 64, 128, 256, 512),
                    strides=(2, 2, 2, 2), num_res_units=2)
    shapes = jax.eval_shape(lambda: JaxUNet3D(**flagship).init(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, 16, 16, 16, 2)), train=True))["params"]
    model = UNet3D(**flagship, device="cpu")
    assert param_count(model) == jax_param_count(shapes) == sum(p.numel() for p in model.parameters())
    assert len(list(model.parameters())) == 82
    want = flat_flax(joptim.no_decay_mask(shapes, NO_DECAY["no_decay_keys"], True))
    got = {flax_path(n): v for n, v in toptim.no_decay_mask(model, NO_DECAY["no_decay_keys"]).items()}
    assert got == {k: bool(v) for k, v in want.items()}
    assert sum(got.values()) == 32  # the 32 conv and transposed-conv kernels take decay


OPTIMIZERS = {
    "sgd": {"optimizer": "sgd", "optimizers": {"sgd": {"lr": 0.05}}},
    "sgd_momentum_wd": {"optimizer": "sgd", "optimizers": {"sgd": {"lr": 0.05, "momentum": 0.9,
                                                                     "weight_decay": 1e-2}}},
    "sgd_nesterov_wd": {"optimizer": "sgd", "optimizers": {"sgd": {"lr": 0.05, "momentum": 0.9, "nesterov": True,
                                                                     "weight_decay": 1e-2}}},
    "adam": {"optimizer": "adam", "optimizers": {"adam": {"lr": 1e-3, "betas": [0.9, 0.99]}}},
    "adam_wd": {"optimizer": "adam", "optimizers": {"adam": {"lr": 1e-3, "weight_decay": 5e-2,
                                                             "betas": [0.9, 0.9999], "eps": 1e-8}}},
    "adamw": {"optimizer": "adamw", "optimizers": {"adamw": {"lr": 1e-3, "weight_decay": 0.05}}},
    "adam_wd_accum2": {"optimizer": "adam", "grad_accum": 2,
                       "optimizers": {"adam": {"lr": 1e-3, "weight_decay": 5e-2}}},
    "sgd_momentum_accum3": {"optimizer": "sgd", "grad_accum": 3,
                            "optimizers": {"sgd": {"lr": 0.05, "momentum": 0.9, "weight_decay": 1e-2}}},
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updates_match_optax(flax_params, name):
    """The same params and per-step gradients through the optax chain and the
    torch optimizer; the params compared after every update (6 updates under
    gradient accumulation, 3 otherwise)."""
    training = dict(OPTIMIZERS[name], param_groups=NO_DECAY)
    tx, lr = joptim.build_optimizer(JaxConfigNode(training), flax_params)
    model = port_model(flax_params)
    optimizer, lr_t = toptim.build_optimizer(ConfigNode(training), model)
    assert lr_t == lr
    state = TrainState(model=model, optimizer=optimizer)
    accum = training.get("grad_accum", 1)
    assert isinstance(optimizer, toptim.MultiSteps) == (accum > 1)

    atol = UPDATE_ATOL
    if training["optimizer"] != "sgd":
        b2 = training["optimizers"][training["optimizer"]].get("betas", [0.9, 0.999])[1]
        atol += lr * 2.0 ** -23 / (1.0 - b2) * 3

    params, opt_state = flax_params, tx.init(flax_params)
    rng = np.random.RandomState(7)
    for step in range(3 * accum):
        grads = jax.tree_util.tree_map(lambda a: (rng.randn(*a.shape) * 0.5).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tg = unet3d_from_flax(grads)
        for n, p in model.named_parameters():
            p.grad = tg[n].clone()
        applied = state.apply_gradients()
        assert applied == ((step + 1) % accum == 0)
        want = unet3d_from_flax(jax.tree_util.tree_map(np.asarray, params))
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=UPDATE_RTOL,
                                       atol=atol, err_msg=f"{name} step {step} {n}")
    assert state.step == 3 * accum


def test_learning_rate_is_set_through_multisteps(flax_params):
    training = ConfigNode({"optimizer": "adam", "grad_accum": 2, "optimizers": {"adam": {"lr": 1e-3}}})
    optimizer, _ = toptim.build_optimizer(training, port_model(flax_params))
    toptim.set_learning_rate(optimizer, 2.5e-4)
    assert toptim.get_learning_rate(optimizer) == 2.5e-4
    assert all(g["lr"] == 2.5e-4 for g in optimizer.optimizer.param_groups)


def test_multisteps_state_dict_round_trip(flax_params):
    training = ConfigNode({"optimizer": "adam", "grad_accum": 3, "optimizers": {"adam": {"lr": 1e-3}}})
    model = port_model(flax_params)
    optimizer, _ = toptim.build_optimizer(training, model)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    optimizer.step()
    sd = optimizer.state_dict()
    other, _ = toptim.build_optimizer(training, port_model(flax_params))
    other.load_state_dict(sd)
    assert other.mini_step == 1
    assert all(torch.equal(a, b) for a, b in zip(other.acc, optimizer.acc))


def test_build_optimizer_errors(flax_params):
    model = port_model(flax_params)
    # adafactor raised before the training-options slice
    # (tests/test_torch_adafactor.py holds it to optax.adafactor)
    assert isinstance(toptim.build_optimizer(ConfigNode({"optimizer": "adafactor"}), model)[0], toptim.Adafactor)
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        toptim.build_optimizer(ConfigNode({"optimizer": "lion"}), model)
    with pytest.raises(ValueError, match="grad_accum"):
        toptim.build_optimizer(ConfigNode({"optimizer": "sgd", "grad_accum": 0}), model)


SCHEDULES = [
    {"name": "none"},
    {"name": "none", "args": {"warmup_epochs": 4}},
    {"name": "poly"},
    {"name": "poly", "args": {"power": 2.0, "warmup_epochs": 3}},
    {"name": "step", "args": {"step_size": 7, "gamma": 0.5}},
    {"name": "multistep", "args": {"milestones": [5, 11, 30], "gamma": 0.3}},
    {"name": "cosine"},
    {"name": "cosine", "args": {"warmup_epochs": 2}},
    {"name": "reduce_on_plateau", "args": {"reduce_on_plateau": {"factor": 0.5, "patience": 1,
                                                                 "min_lr": 1e-5}}},
    {"name": "reduce_on_plateau"},
    {"name": "unknown_name"},
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: s["name"] + ("_args" if "args" in s else ""))
def test_epoch_scheduler_matches_reference_exactly(sched):
    training = {"epochs": 24, "scheduler": sched}
    jax_s = joptim.EpochScheduler(JaxConfigNode(training), 1e-3)
    port_s = toptim.EpochScheduler(ConfigNode(training), 1e-3)
    assert port_s.enabled == jax_s.enabled
    losses = [1.0, 0.9, 0.95, 0.96, 0.97, 0.8, 0.85, 0.85, 0.86, 0.9, 0.7] * 3
    for epoch in range(training["epochs"] + 2):
        val = None if epoch == 0 else losses[epoch]
        assert port_s.lr_for_epoch(epoch, val) == jax_s.lr_for_epoch(epoch, val)
    assert port_s.state_dict() == jax_s.state_dict()
    other = toptim.EpochScheduler(ConfigNode(training), 1e-3)
    other.load_state_dict(port_s.state_dict())
    assert other.state_dict() == port_s.state_dict()
