"""Parity of the port's supervised trainer
(multimodal_tta_tpu_torch/core/trainers/seg_trainer.py, trainer_base.py,
ops/augment.py) with the JAX reference, on the small UNet3D (channels
(4, 8, 16), strides (2, 2), f32) over [2, 8, 16, 16, 2] batches with the
HECKTOR21 normalization on the device and the augmentations off.

Tolerances (f32; the two packages convolve in other orders):
  - loss of each step: 2e-5 relative;
  - params after each step: 1e-5 relative + 2e-6 absolute (SGD), and for
    Adam + 2e-6 absolute per step taken (Adam divides by sqrt(v), so an
    element whose gradient is tiny carries the gradient's relative noise
    into an update of size lr);
  - the EMA shadow: as the params;
  - the augmentations given the same draws: 1e-6 (one rounding apart);
  - validation metrics in the 2-epoch history: 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core import optim as joptim
from multimodal_tta_tpu.core.hooks import EarlyStoppingHook as JaxEarlyStoppingHook
from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
from multimodal_tta_tpu.core.trainers.seg_trainer import SegTrainer as JaxSegTrainer
from multimodal_tta_tpu.data.loader import HostLoader as JaxHostLoader
from multimodal_tta_tpu.evaluation import SegmentationEvaluationStrategy as JaxStrategy
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu.ops import augment as jaug
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core import optim as toptim
from multimodal_tta_tpu_torch.core.hooks import EarlyStoppingHook
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.core.trainer_base import HookBase, TrainerBase
from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
from multimodal_tta_tpu_torch.data import HostLoader
from multimodal_tta_tpu_torch.evaluation.seg_eval import SegmentationEvaluationStrategy
from multimodal_tta_tpu_torch.models.convert import unet3d_from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.ops import augment as taug

from _torch_port import DEVICE_TRANSFORM, HECKTOR_POLICY, SMALL, SMALL_SHAPE, load_flax, random_flax_params

torch.set_num_threads(1)

LOSS_RTOL = 2e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-6
NO_DECAY = {"no_decay_keys": ["bias", "bn", "norm", "scale"], "treat_1d_as_no_decay": True}
HECKTOR_CRITERION = {"sigmoid": True, "lambda_dice": 5.0, "lambda_ce": 1.0, "ce_weight": [50.0],
                     "include_background": False}


def make_volumes(n: int, seed: int, classes: int = 0):
    """CT/PET-like volumes [n, 8, 16, 16, 2] with an ellipsoid lesion each:
    sigmoid labels [n, 8, 16, 16, 1], or class maps [n, 8, 16, 16] with
    ``classes`` classes (lesion core and rim)."""
    rng = np.random.RandomState(seed)
    d, h, w, _ = SMALL_SHAPE
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
    images, labels = [], []
    for _ in range(n):
        c = rng.uniform((2, 4, 4), (6, 12, 12))
        r = rng.uniform((1.5, 2.5, 2.5), (3.0, 5.0, 5.0))
        dist = ((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2 + ((xx - c[2]) / r[2]) ** 2
        lesion = dist <= 1.0
        ct = rng.randn(d, h, w) * 250.0 - 300.0 + 400.0 * lesion
        ct[rng.rand(d, h, w) < 0.2] = -1000.0  # air
        pt = np.abs(rng.randn(d, h, w)) * 1.5 + 6.0 * lesion
        images.append(np.stack([ct, pt], axis=-1).astype(np.float32))
        if classes:
            labels.append((lesion.astype(np.int32) + (dist <= 0.3)).astype(np.int32))
        else:
            labels.append(lesion[..., None].astype(np.float32))
    return np.stack(images), np.stack(labels)


def batches(n_batches: int, seed: int, classes: int = 0):
    img, lbl = make_volumes(2 * n_batches, seed, classes)
    return [{"image": img[2 * i:2 * i + 2], "label": lbl[2 * i:2 * i + 2]} for i in range(n_batches)]


@pytest.fixture(scope="module")
def params1():
    return random_flax_params(JaxUNet3D(**SMALL, dtype=jnp.float32), (1,) + SMALL_SHAPE, seed=3)


def config(training: dict, **top) -> dict:
    t = {"param_groups": NO_DECAY, "criterion": HECKTOR_CRITERION}
    t.update(training)
    return {"task": {"seed": 0}, "training": t, **top}


def jax_trainer(cfg: dict, params, device_transform=DEVICE_TRANSFORM, strategy=None, classes: int = 1):
    jcfg = JaxConfigNode(cfg)
    trainer = JaxSegTrainer(jcfg, mesh=None, evaluation_strategy=strategy, device_transform=device_transform)
    module = JaxUNet3D(**dict(SMALL, num_classes=classes), dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx, lr = joptim.build_optimizer(jcfg.training, params)
    trainer.setup(JaxTrainState.create(apply_fn=module.apply, params=params, tx=tx), strategy,
                  joptim.EpochScheduler(jcfg.training, lr))
    return trainer


def port_trainer(cfg: dict, params, device_transform=DEVICE_TRANSFORM, strategy=None, classes: int = 1):
    pcfg = ConfigNode(cfg)
    trainer = SegTrainer(pcfg, evaluation_strategy=strategy, device_transform=device_transform, device="cpu")
    model = load_flax(UNet3D(**dict(SMALL, num_classes=classes), dtype=torch.float32, device="cpu"), params)
    optimizer, lr = toptim.build_optimizer(pcfg.training, model)
    trainer.setup(TrainState(model=model, optimizer=optimizer), strategy, toptim.EpochScheduler(pcfg.training, lr))
    return trainer


def assert_params_close(got: dict, want_flax, atol: float, what: str):
    want = unet3d_from_flax(jax.tree_util.tree_map(np.asarray, want_flax))
    assert set(got) == set(want)
    for n, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=PARAM_RTOL, atol=atol,
                                   err_msg=f"{what}: {n}")


STEP_CASES = {
    "sgd": {"optimizer": "sgd", "optimizers": {"sgd": {"lr": 0.01, "momentum": 0.9, "weight_decay": 1e-3}}},
    "adam": {"optimizer": "adam", "optimizers": {"adam": {"lr": 1e-3, "weight_decay": 5e-4,
                                                          "betas": [0.9, 0.9999]}}},
    "adam_ema": {"optimizer": "adam", "optimizers": {"adam": {"lr": 1e-3, "weight_decay": 5e-4}},
                 "ema": {"enabled": True, "decay": 0.8}},
    "sgd_accum2_ema": {"optimizer": "sgd", "grad_accum": 2,
                       "optimizers": {"sgd": {"lr": 0.01, "momentum": 0.9, "weight_decay": 1e-3}},
                       "ema": {"enabled": True, "decay": 0.8}},
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_run_steps_match_reference(params1, case):
    """Three run_steps of the JAX and the port trainer on the same batches:
    the loss of each step and the params (and EMA shadow) after it."""
    cfg = config(STEP_CASES[case])
    jt, pt = jax_trainer(cfg, params1), port_trainer(cfg, params1)
    adam = cfg["training"]["optimizer"] == "adam"
    for i, batch in enumerate(batches(3, seed=10)):
        assert jt.run_step(batch) == {} and pt.run_step(batch) == {}  # the loss comes one step late
        want, got = jt.flush_step_metrics()["loss"], pt.flush_step_metrics()["loss"]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=f"{case} loss of step {i}")
        atol = PARAM_ATOL * (i + 2 if adam else 1)
        assert_params_close(dict(pt.state.model.named_parameters()), jt.state.params, atol,
                            f"{case} params after step {i}")
        if pt.ema_enabled:
            assert_params_close(pt.state.ema_params, jt.state.ema_params, atol, f"{case} EMA after step {i}")
    assert pt.state.step == int(jt.state.step) == 3
    if case == "sgd_accum2_ema":  # one apply (step 2): the shadow moved once, and is not the params
        assert pt.state.optimizer.mini_step == 1
        assert any(not torch.equal(pt.state.ema_params[n], p) for n, p in pt.state.model.named_parameters())


def test_eval_state_carries_the_shadow_and_leaves_the_live_params(params1):
    cfg = config(STEP_CASES["adam_ema"])
    pt = port_trainer(cfg, params1)
    model = pt.state.model
    assert pt.eval_state() is model  # no shadow before the first step
    for batch in batches(2, seed=11):
        pt.run_step(batch)
    live = {n: p.detach().clone() for n, p in model.named_parameters()}
    shadow = pt.eval_state()
    assert shadow is not model and pt.eval_state() is shadow  # one copy, kept
    for n, p in shadow.named_parameters():
        assert torch.equal(p, pt.state.ema_params[n]) and not p.requires_grad
        assert torch.equal(dict(model.named_parameters())[n], live[n])
    opt_params = [p for g in pt.state.optimizer.param_groups for p in g["params"]]
    assert {id(p) for p in opt_params} == {id(p) for p in model.parameters()}
    pt.ema_eval = False
    assert pt.eval_state() is model


def test_intensity_scale_shift_given_the_same_draws():
    x = np.random.RandomState(0).randn(5, 4, 6, 6, 2).astype(np.float32)
    key = jax.random.PRNGKey(4)
    scale, shift, prob = 0.1, 0.2, 0.5
    want = jaug.rand_intensity_scale_shift(key, jnp.asarray(x), scale=scale, shift=shift, prob=prob)
    k1, k2, k3, k4 = jax.random.split(key, 4)  # the reference's draws
    factor = np.where(jax.random.uniform(k1, (5,)) < prob,
                      1.0 + jax.random.uniform(k2, (5,), minval=-scale, maxval=scale), 1.0)
    offset = np.where(jax.random.uniform(k3, (5,)) < prob,
                      jax.random.uniform(k4, (5,), minval=-shift, maxval=shift), 0.0)
    got = taug.apply_intensity_scale_shift(torch.from_numpy(x), torch.from_numpy(factor.astype(np.float32)),
                                           torch.from_numpy(offset.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    gen = torch.Generator().manual_seed(0)
    f, o = taug.intensity_scale_shift_draws(4000, gen, scale=scale, shift=shift, prob=prob)
    assert f.shape == o.shape == (4000,)
    assert bool(((f >= 1 - scale) & (f < 1 + scale)).all()) and bool(((o >= -shift) & (o < shift)).all())
    assert abs(float((f != 1).float().mean()) - prob) < 0.05
    assert abs(float((o != 0).float().mean()) - prob) < 0.05


def test_modality_dropout_given_the_same_draws():
    x = np.random.RandomState(1).randn(64, 3, 4, 4, 3).astype(np.float32) + 5.0
    key = jax.random.PRNGKey(5)
    want = jaug.modality_dropout(key, jnp.asarray(x), prob=0.6)
    k1, k2 = jax.random.split(key)
    drop = np.array(jax.random.uniform(k1, (64, 3)) < 0.6)
    drop[np.arange(64), np.asarray(jax.random.randint(k2, (64,), 0, 3))] = False
    got = taug.apply_modality_dropout(torch.from_numpy(x), torch.from_numpy(drop))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    gen = torch.Generator().manual_seed(0)
    d = taug.modality_dropout_draws(4000, 3, gen, prob=0.6)
    assert d.dtype == torch.bool and d.shape == (4000, 3)
    assert bool((~d).any(dim=1).all())  # one modality always survives
    out = taug.modality_dropout(torch.from_numpy(x), torch.Generator().manual_seed(1), prob=0.6)
    kept = (out != 0).reshape(64, -1, 3).all(dim=1)
    assert bool(kept.any(dim=1).all()) and bool(((out == 0) | (out == torch.from_numpy(x))).all())


def test_augmented_step_draws_from_the_trainer_generator(params1):
    """With both augmentations on, the step consumes the trainer's generator
    (seeded by task.seed): the same seed gives the same step, bitwise."""
    spec = dict(DEVICE_TRANSFORM, intensity_aug=True, modality_dropout=True, modality_dropout_prob=0.5)
    cfg = config(STEP_CASES["sgd"])
    runs = []
    for _ in range(2):
        pt = port_trainer(cfg, params1, device_transform=spec)
        for batch in batches(2, seed=12):
            pt.run_step(batch)
        runs.append(pt)
    for (n, p), q in zip(runs[0].state.model.named_parameters(), runs[1].state.model.parameters()):
        assert torch.equal(p, q), n
    plain = port_trainer(cfg, params1)
    plain.run_step(batches(1, seed=12)[0])
    assert plain.flush_step_metrics() != runs[0].flush_step_metrics()


def test_gwdl_softmax_steps_match_reference():
    """Softmax label maps with the generalized Wasserstein Dice + CE."""
    params3 = random_flax_params(JaxUNet3D(**dict(SMALL, num_classes=3), dtype=jnp.float32),
                                 (1,) + SMALL_SHAPE, seed=4)
    crit = {"name": "gwdl", "softmax": True, "lambda_ce": 1.0, "ce_weight": [1.0, 2.0, 4.0],
            "distance_matrix": [[0.0, 1.0, 1.0], [1.0, 0.0, 0.5], [1.0, 0.5, 0.0]]}
    cfg = config({"optimizer": "sgd", "optimizers": {"sgd": {"lr": 0.01, "momentum": 0.9}}, "criterion": crit})
    jt, pt = jax_trainer(cfg, params3, classes=3), port_trainer(cfg, params3, classes=3)
    for i, batch in enumerate(batches(2, seed=13, classes=3)):
        jt.run_step(batch)
        pt.run_step(batch)
        want, got = jt.flush_step_metrics()["loss"], pt.flush_step_metrics()["loss"]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=f"gwdl loss of step {i}")
        assert_params_close(dict(pt.state.model.named_parameters()), jt.state.params, PARAM_ATOL,
                            f"gwdl params after step {i}")


def test_train_with_validation_matches_reference(params1):
    """TrainerBase.train over 2 epochs (poly schedule, validation each epoch
    through seg_eval, f16 transfer): the histories' keys and values and the
    best metrics against the JAX run."""
    cfg = config({"optimizer": "adam", "optimizers": {"adam": {"lr": 2e-3}}, "epochs": 2,
                  "scheduler": {"name": "poly"}, "transfer_dtype": "float16",
                  "eval_test": {"every_n_epochs": 1},
                  "data": {"transforms": {"on_device": True, "normalize": True,
                                          "intensity_policy": HECKTOR_POLICY}}},
                 dataset={"modality_order": ["ct", "pt"]},
                 evaluation={"seg": {"region_order": ["gtvt"], "threshold": 0.3, "spacing": [3.0, 1.0, 1.0]},
                             "loss": {"report_loss": True}})
    img, lbl = make_volumes(6, seed=14)
    doms = ["CHUM", "CHGJ"] * 3
    samples = [{"image": img[i], "label": lbl[i], "domain": doms[i]} for i in range(6)]
    loaders = {}
    for tag, cls in (("jax", JaxHostLoader), ("port", HostLoader)):
        loaders[tag] = (cls(samples[:4], batch_size=2, shuffle=True, drop_last=True, num_workers=0, seed=5),
                        cls(samples[4:], batch_size=2, num_workers=0))
    jt = jax_trainer(cfg, params1, strategy=JaxStrategy(JaxConfigNode(cfg)))
    pt = port_trainer(cfg, params1, strategy=SegmentationEvaluationStrategy(ConfigNode(cfg)))
    want = jt.train(2, *loaders["jax"])
    got = pt.train(2, *loaders["port"])
    for key in ("train_history", "eval_history"):
        assert len(got[key]) == len(want[key]) == 2
        for g, w in zip(got[key], want[key]):
            assert set(g) == set(w), key
            for k in w:
                rtol = LOSS_RTOL if key == "train_history" else 1e-4
                np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-4 if key == "eval_history" else 0,
                                           err_msg=f"{key} {k}")
    assert set(pt.best_metrics) == set(jt.best_metrics)
    assert pt.epoch == jt.epoch == 1 and pt.iter == jt.iter == 4


# ---- the scheduling and hook cases of tests/test_trainer_base.py, on the port ----


class _ToyTrainer(TrainerBase):
    """Minimal concrete trainer: counts steps."""

    def __init__(self, config):
        super().__init__(config, device="cpu")
        self.state = object()
        self.steps = 0

    def run_step(self, batch):
        self.steps += 1
        return {"loss": 1.0 / self.steps}


class _FakeStrategy:
    def __init__(self, losses):
        self.losses = list(losses)
        self.calls = 0

    def evaluate_epoch(self, state, loader, **kw):
        self.calls += 1
        return {"loss": self.losses.pop(0) if self.losses else 0.0, "avg_dc": 0.5}


def sched_cfg(schedule=None, do_test=False):
    c = {"training": {"eval_test": {"start_epoch": 0, "every_n_epochs": 1, "run_last": True,
                                    "do_val": True, "do_test": do_test}}}
    if schedule:
        c["training"]["eval_test"].update(schedule)
    return c


@pytest.mark.parametrize("schedule,epochs,runs", [
    (None, 10, list(range(10))),
    ({"every_n_epochs": 5}, 20, [0, 5, 10, 15, 19]),
    ({"start_epoch": 3, "every_n_epochs": 2, "run_last": False}, 10, [3, 5, 7, 9]),
    ({"every_n_epochs": 100, "run_last": True}, 7, [0, 6]),
    ({"every_n_epochs": 0}, 5, list(range(5))),
    ({"every_n_epochs": None, "start_epoch": 2}, 5, [2, 3, 4]),
], ids=["every", "every_n", "start_epoch", "run_last", "zero_interval", "none_interval"])
def test_eval_schedule_matches_reference(schedule, epochs, runs):
    from multimodal_tta_tpu.core.trainer_base import TrainerBase as JaxTrainerBase

    class JaxToy(JaxTrainerBase):
        def run_step(self, batch):
            return {}

    got = [e for e in range(epochs) if _ToyTrainer(ConfigNode(sched_cfg(schedule)))._should_run_eval_test(e, epochs)]
    want = [e for e in range(epochs) if JaxToy(JaxConfigNode(sched_cfg(schedule)))._should_run_eval_test(e, epochs)]
    assert got == want == runs


class _Recorder(HookBase):
    def __init__(self, events):
        self.events = events

    def _rec(name):
        def f(self, *args):
            self.events.append(name if not args or name != "end" else f"end{args[0]}")
        return f

    before_train, after_train = _rec("before_train"), _rec("after_train")
    before_train_epoch, after_train_epoch = _rec("bte"), _rec("ate")
    before_train_step, after_train_step = _rec("bts"), _rec("ats")
    before_val, on_epoch_end = _rec("bv"), _rec("end")

    def after_val(self, is_best):
        self.events.append(f"av{int(is_best)}")


def test_history_and_hook_order():
    events = []
    t = _ToyTrainer(ConfigNode(sched_cfg()))
    t.setup(object(), _FakeStrategy([0.5, 0.4]))
    t.register_hooks([_Recorder(events), None])
    out = t.train(2, [{"x": i} for i in range(2)], val_loader=[{}])
    assert len(out["train_history"]) == 2 and len(out["eval_history"]) == 2
    assert out["eval_history"][0]["loss"] == 0.5
    one_epoch = ["bte", "bts", "ats", "bts", "ats", "ate", "bv", "av0"]
    assert events == ["before_train"] + one_epoch + ["end0"] + one_epoch + ["end1", "after_train"]
    with pytest.raises(TypeError):
        t.register_hooks([object()])


def test_eval_history_empty_when_not_scheduled():
    t = _ToyTrainer(ConfigNode(sched_cfg({"every_n_epochs": 2, "run_last": False})))
    t.setup(object(), _FakeStrategy([0.5, 0.4]))
    out = t.train(3, [{"x": 0}], val_loader=[{}])
    assert out["eval_history"][1] == {}


def test_early_stopping_raises_stop():
    t = _ToyTrainer(ConfigNode(sched_cfg()))
    t.setup(object(), _FakeStrategy([1.0, 1.1, 1.2, 1.3, 1.4, 1.5]))
    t.register_hooks([EarlyStoppingHook(metric="loss", mode="min", patience=1)])
    out = t.train(6, [{"x": 0}], val_loader=[{}])
    assert len(out["train_history"]) == 3  # best at 0, two bad epochs > patience 1


@pytest.mark.parametrize("mode,min_delta,patience", [("min", 0.0, 1), ("max", 0.05, 0), ("min", 0.1, 2)])
def test_early_stopping_decisions_match_reference(mode, min_delta, patience):
    values = [1.0, 0.95, 0.97, 1.02, 0.9, 0.91, 0.93, 1.1, 1.2, 0.5]
    stops = []
    for cls in (EarlyStoppingHook, JaxEarlyStoppingHook):
        hook, stopped = cls(metric="avg_dc", mode=mode, patience=patience, min_delta=min_delta), []
        for epoch, v in enumerate(values):
            try:
                hook.on_epoch_end(epoch, {}, {"avg_dc": v}, False)
            except StopIteration:
                stopped.append(epoch)
            hook.on_epoch_end(epoch, {}, {}, False)  # no metric: no decision
        stops.append((stopped, hook.best, hook.bad))
    assert stops[0] == stops[1]


def test_test_loader_called_when_enabled():
    t = _ToyTrainer(ConfigNode(sched_cfg(do_test=True)))
    strategy = _FakeStrategy([0.5, 0.4, 0.3, 0.2])
    t.setup(object(), strategy)
    t.train(2, [{"x": 0}], val_loader=[{}], test_loader=[{}])
    assert strategy.calls == 4  # 2 val + 2 test


def test_zero_batch_epoch_reports_nan_loss():
    t = _ToyTrainer(ConfigNode({"training": {}}))
    assert math.isnan(t.train_epoch(0, [])["loss"])


def test_best_model_selection_follows_the_strategy_or_the_loss(params1):
    cfg = config(STEP_CASES["sgd"], evaluation={"best_metric": "avg_dc", "best_mode": "max"})
    t = port_trainer(cfg, params1, strategy=SegmentationEvaluationStrategy(ConfigNode(cfg)))
    assert t._is_best_model({"avg_dc": 0.7})
    t.best_metrics = {"avg_dc": 0.7}
    assert not t._is_best_model({"avg_dc": 0.6})
    t.evaluation_strategy = None
    assert t._is_best_model({"loss": 1.0}) and not t._is_best_model({})


def test_epoch_stepped_lr_and_loader_epoch(params1):
    """The scheduler's LR is set at each epoch's start and lands in the
    history; the loader is told its epoch (a resumed run gets that epoch's
    shuffle order)."""
    cfg = config({"optimizer": "sgd", "optimizers": {"sgd": {"lr": 0.1}}, "epochs": 3,
                  "scheduler": {"name": "step", "args": {"step_size": 1, "gamma": 0.5}}})
    pt = port_trainer(cfg, params1)
    img, lbl = make_volumes(2, seed=15)
    loader = HostLoader([{"image": img[i], "label": lbl[i]} for i in range(2)], batch_size=2,
                        shuffle=True, num_workers=0)
    pt.start_epoch = 1
    out = pt.train(3, loader)
    assert [h["lr"] for h in out["train_history"]] == [0.05, 0.025]
    assert loader._epoch == 2


@pytest.mark.parametrize("key,value", [
    ("model.deep_supervision", 2), ("model.moe_experts", 4), ("training.distill.enabled", True)])
def test_unported_options_raise(params1, key, value):
    """These options raised NotImplementedError before the training-options
    slice; they are ported (tests/test_torch_deep_supervision.py,
    test_torch_moe.py, test_torch_distill.py). Misused, each raises the
    reference's error: deep supervision or MoE asked of a model that sows
    no ``ds{k}`` / ``moe_aux`` (the small dense UNet3D) at the step, with the
    reference's text; distillation without a checkpoint at construction."""
    cfg = config(STEP_CASES["sgd"])
    section, name = key.split(".", 1)
    node = cfg.setdefault(section, {})
    for part in name.split(".")[:-1]:
        node = node.setdefault(part, {})
    node[name.split(".")[-1]] = value
    batch = batches(1, seed=10)[0]
    raised = []
    for make in (jax_trainer, port_trainer):
        with pytest.raises((ValueError, KeyError)) as err:
            make(cfg, params1).run_step(batch)
        raised.append((err.type, str(err.value)))
    assert raised[0] == raised[1]
    assert ("sowed no" in raised[1][1]) if section == "model" else ("checkpoint" in raised[1][1])


@pytest.mark.parametrize("criterion,image,label", [
    ({"sigmoid": True}, (2, 8, 16, 16, 2), (2, 8, 16, 16)),
    ({"sigmoid": True}, (2, 8, 16, 16, 2), (2, 8, 16, 8, 1)),
    ({"softmax": True}, (2, 8, 16, 16, 2), (2, 8, 16, 16, 1)),
    ({"softmax": True}, (2, 8, 16, 16, 2), (2, 8, 16, 8)),
])
def test_shape_check_messages_match_reference(criterion, image, label):
    cfg = {"task": {"seed": 0}, "training": {"criterion": criterion}}
    messages = []
    for trainer in (SegTrainer(ConfigNode(cfg), device="cpu"), JaxSegTrainer(JaxConfigNode(cfg), mesh=None)):
        with pytest.raises(ValueError) as e:
            trainer.run_step({"image": np.zeros(image, np.float32), "label": np.zeros(label, np.float32)})
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_set_random_seed_modes():
    """The three presets: seeded host RNGs and a seeded generator; "strict"
    turns on deterministic algorithms, the others turn them off again; an
    unknown mode raises as in the reference."""
    import os
    import random

    from multimodal_tta_tpu.utils.metrics import set_random_seed as jax_set_random_seed
    from multimodal_tta_tpu_torch.utils.metrics import AverageMeter, set_random_seed

    saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    try:
        for mode in ("off", "practical", "strict"):
            gen = set_random_seed(5, mode)
            draws = (random.random(), np.random.rand(), float(torch.rand(1)), float(torch.rand(1, generator=gen)))
            jax_set_random_seed(5, "off")  # the reference seeds the host RNGs the same way
            assert draws[:2] == (random.random(), np.random.rand())
            assert draws[3] == float(torch.rand(1, generator=torch.Generator().manual_seed(5)))
            strict = mode == "strict"
            assert torch.are_deterministic_algorithms_enabled() == strict == torch.backends.cudnn.deterministic
        for bad in ("full", "STRICTER"):
            with pytest.raises(ValueError, match="Unknown deterministic mode"):
                set_random_seed(0, bad)
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1], saved[2]
        if saved[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    m = AverageMeter()
    for v, n in ((1.0, 1), (4.0, 3)):
        m.update(v, n)
    assert (m.val, m.sum, m.count, m.avg) == (4.0, 13.0, 4, 3.25)
