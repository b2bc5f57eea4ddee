"""The port's checkpoints (multimodal_tta_tpu_torch/core/checkpoint.py,
hooks.py) and experiment manager (core/experiment_manager.py) on the CPU:
a round trip is bitwise and leaves no ``.tmp`` behind; a run resumed from a
checkpoint through ``training.resume`` equals an uninterrupted run bitwise;
the EMA shadow toggled between save and load is handled as the reference
does; ``resolve_serving_params`` against the reference's contract; the
options not ported raise. The formats, the reference's msgpack (the
default) and orbax and the port's ``.pt``, round-trip."""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_tta_tpu.core.checkpoint import resolve_serving_params as jax_resolve_serving_params
from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core import flax_msgpack
from multimodal_tta_tpu_torch.core import optim as toptim
from multimodal_tta_tpu_torch.core.checkpoint import load_checkpoint, resolve_serving_params, save_checkpoint
from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
from multimodal_tta_tpu_torch.core.hooks import CheckpointHook
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
from multimodal_tta_tpu_torch.data import HostLoader, get_seg_transforms
from multimodal_tta_tpu_torch.models.convert import unet3d_from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D

from _torch_port import DEVICE_TRANSFORM, HECKTOR_POLICY, SMALL, SMALL_SHAPE, flat_flax, random_flax_params

torch.set_num_threads(1)

ADAM = {"optimizer": "adam", "optimizers": {"adam": {"lr": 2e-3, "weight_decay": 5e-4}},
        "param_groups": {"no_decay_keys": ["bias", "bn", "norm", "scale"]},
        "criterion": {"sigmoid": True, "lambda_dice": 5.0, "ce_weight": [50.0]}}


def volumes(n: int, seed: int):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        image = np.stack([rng.randn(*SMALL_SHAPE[:3]) * 300.0 - 200.0,
                          np.abs(rng.randn(*SMALL_SHAPE[:3])) * 3.0], axis=-1).astype(np.float32)
        label = (rng.rand(*SMALL_SHAPE[:3], 1) > 0.8).astype(np.float32)
        out.append({"image": image, "label": label, "domain": "CHUM" if i % 2 else "CHGJ"})
    return out


def trained_state(training: dict, steps: int = 2, seed: int = 0) -> SegTrainer:
    cfg = ConfigNode({"task": {"seed": seed}, "training": training})
    model = UNet3D(**SMALL, dtype=torch.float32, device="cpu", seed=seed)
    optimizer, _ = toptim.build_optimizer(cfg.training, model)
    trainer = SegTrainer(cfg, device_transform=DEVICE_TRANSFORM, device="cpu")
    trainer.setup(TrainState(model=model, optimizer=optimizer))
    for i in range(steps):
        v = volumes(2, seed=100 + i)
        trainer.run_step({"image": np.stack([s["image"] for s in v]), "label": np.stack([s["label"] for s in v])})
    return trainer


def optimizer_tensors(optimizer) -> list:
    sd = optimizer.state_dict()
    inner = sd["inner"] if "inner" in sd else sd
    out = [v for st in inner["state"].values() for v in st.values() if torch.is_tensor(v)]
    return out + list(sd.get("acc") or [])


def assert_states_equal(a: TrainState, b: TrainState) -> None:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    ta, tb = optimizer_tensors(a.optimizer), optimizer_tensors(b.optimizer)
    assert len(ta) == len(tb) > 0 and all(torch.equal(x, y) for x, y in zip(ta, tb))
    assert [g["lr"] for g in a.optimizer.param_groups] == [g["lr"] for g in b.optimizer.param_groups]
    assert a.step == b.step
    assert (a.ema_params is None) == (b.ema_params is None)
    if a.ema_params is not None:
        assert all(torch.equal(a.ema_params[k], b.ema_params[k]) for k in a.ema_params)


@pytest.mark.parametrize("fmt", ["msgpack", "torch"])
@pytest.mark.parametrize("case", ["adam", "adam_ema", "sgd_accum3"])
def test_round_trip_is_bitwise(tmp_path, case, fmt):
    training = dict(ADAM)
    if case == "adam_ema":
        training["ema"] = {"enabled": True, "decay": 0.9}
    if case == "sgd_accum3":
        training.update(optimizer="sgd", grad_accum=3, optimizers={"sgd": {"lr": 0.01, "momentum": 0.9}})
    src = trained_state(training).state
    extra = {"epoch": 4, "best_metrics": {"loss": 0.25, "avg_dc": float("inf")},
             "scheduler": {"rop_best": float("inf"), "rop_bad": 0, "rop_lr": 1e-3}}
    path = str(tmp_path / "ckpt" / "best_model")
    save_checkpoint(path, src, extra, fmt=fmt)
    ext = {"msgpack": "msgpack", "torch": "pt"}[fmt]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["best_model.json", f"best_model.{ext}"]  # no .tmp left

    template = trained_state(dict(training, ema={"enabled": False}), steps=1, seed=1).state
    template.ema_params = None
    got, meta = load_checkpoint(path, template)
    assert got.model is template.model and got.optimizer is template.optimizer
    assert_states_equal(got, src)
    assert meta == dict(extra, _format=fmt)


def test_ema_toggled_between_save_and_load(tmp_path):
    with_ema = trained_state(dict(ADAM, ema={"enabled": True, "decay": 0.9})).state
    save_checkpoint(str(tmp_path / "a"), with_ema)
    template = trained_state(ADAM, steps=1, seed=1).state
    assert template.ema_params is None
    got, _ = load_checkpoint(str(tmp_path / "a"), template)  # the shadow is restored all the same
    assert all(torch.equal(got.ema_params[k], with_ema.ema_params[k]) for k in with_ema.ema_params)

    without = trained_state(ADAM, seed=2).state
    save_checkpoint(str(tmp_path / "b"), without)
    template = trained_state(dict(ADAM, ema={"enabled": True, "decay": 0.9}), steps=1, seed=3).state
    got, _ = load_checkpoint(str(tmp_path / "b"), template)  # warm start at the restored params
    params = dict(got.model.named_parameters())
    for k, v in got.ema_params.items():
        assert torch.equal(v, dict(without.model.named_parameters())[k])
        assert v.data_ptr() != params[k].data_ptr()  # a copy, not the live tensor


def test_resolve_serving_params_keeps_the_reference_contract():
    port = trained_state(dict(ADAM, ema={"enabled": True, "decay": 0.9})).state
    assert resolve_serving_params(port, False) is port
    live = {n: p.detach().clone() for n, p in port.model.named_parameters()}
    served = resolve_serving_params(port, True)
    for n, p in served.model.named_parameters():
        assert torch.equal(p, port.ema_params[n])
        assert torch.equal(dict(port.model.named_parameters())[n], live[n])  # the state is untouched
    assert served.optimizer is port.optimizer and served.step == port.step

    bare = trained_state(ADAM, steps=1).state
    module = JaxUNet3D(**SMALL)
    params = random_flax_params(module, (1,) + SMALL_SHAPE)
    jax_bare = JaxTrainState.create(apply_fn=module.apply, params=params, tx=optax.sgd(0.1))
    errors = []
    for fn, state in ((resolve_serving_params, bare), (jax_resolve_serving_params, jax_bare)):
        with pytest.raises(ValueError) as e:
            fn(state, True)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    jax_served = jax_resolve_serving_params(jax_bare.replace(ema_params=params), True)
    assert jax_served.params is params  # the reference swaps the shadow in, as the port does


def manager_config(save_dir: str, **training) -> dict:
    t = dict(ADAM, epochs=3, batch_size=2, compute_dtype="float32", transfer_dtype="float16",
             scheduler={"name": "poly"}, model_save_start=0, model_save_freq=1,
             eval_test={"every_n_epochs": 1},
             data={"transforms": {"normalize": True, "on_device": True, "intensity_policy": HECKTOR_POLICY}})
    t.update(training)
    return {"task": {"name": "hecktor21", "seed": 0, "eval_strategy": "seg_eval", "save_dir": save_dir},
            "dataset": {"modality_order": ["ct", "pt"]},
            "model": {"name": "unet", **{k: list(v) if isinstance(v, tuple) else v for k, v in SMALL.items()}},
            "training": t,
            "evaluation": {"seg": {"region_order": ["gtvt"], "threshold": 0.3, "spacing": [3.0, 1.0, 1.0]},
                           "surface": {"enable": True, "nsd_tol": 2.0}, "loss": {"report_loss": True}}}


def run_manager(cfg: dict, epochs: int):
    m = ExperimentManager(ConfigNode(cfg), device="cpu")
    m.setup_model()
    m.setup_optimizer()
    m.setup_scheduler()
    m.train_loader = HostLoader(volumes(6, seed=1), batch_size=2, shuffle=True, drop_last=True,
                                num_workers=2, seed=0)
    m.val_loader = HostLoader(volumes(2, seed=2), batch_size=2, num_workers=0)
    m.device_transform = get_seg_transforms(
        ndim=3, split="train", geom_aug=False, intensity_aug=False, intensity_policy=HECKTOR_POLICY,
        channel_names=["ct", "pt"], on_device=True).device_spec()
    m.setup_trainer()
    return m, m.train(epochs)


def test_resume_equals_an_uninterrupted_run_bitwise(tmp_path):
    """3 epochs in one run against 1 epoch, then a second manager resumed
    from its best_model for epochs 1-2: params, optimizer state, step,
    scheduler state, best metrics and the later histories, bitwise."""
    full, full_out = run_manager(manager_config(str(tmp_path / "full")), 3)
    first, _ = run_manager(manager_config(str(tmp_path / "first")), 1)
    ckpt = os.path.join(str(tmp_path / "first"), "checkpoints", "best_model")
    resumed, resumed_out = run_manager(manager_config(str(tmp_path / "resumed"), resume=ckpt), 3)

    assert resumed.trainer.start_epoch == 1
    assert_states_equal(resumed.state, full.state)
    assert resumed.state.step == full.state.step == 9
    assert resumed.scheduler.state_dict() == full.scheduler.state_dict()
    assert resumed.trainer.best_metrics == full.trainer.best_metrics
    assert resumed_out["train_history"] == full_out["train_history"][1:]
    assert resumed_out["eval_history"] == full_out["eval_history"][1:]
    saved = sorted(os.listdir(tmp_path / "full" / "checkpoints"))
    assert saved == sorted(f"{n}.{e}" for n in ("best_model", "checkpoint_epoch_0", "checkpoint_epoch_1",
                                                  "checkpoint_epoch_2") for e in ("json", "msgpack"))


def test_manager_defaults_to_cuda_and_raises_what_is_not_ported(tmp_path):
    assert inspect.signature(ExperimentManager).parameters["device"].default == "cuda"
    assert inspect.signature(SegTrainer).parameters["device"].default == "cuda"
    cfg = manager_config(str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ExperimentManager(ConfigNode(cfg))
    unregistered = dict(cfg, task=dict(cfg["task"], name="seg_unregistered"))
    m = ExperimentManager(ConfigNode(unregistered), device="cpu")
    with pytest.raises(KeyError, match="no dataset builder is registered for task 'seg_unregistered'"):
        m.setup_data("train")
    with pytest.raises(ValueError, match="Model must be setup"):
        m.setup_optimizer()
    # model.pretrained is ported (it raised naming the ROADMAP before the
    # BatchNorm slice): without a source it is a ValueError, as in the
    # reference, and the unet family has no torchvision porter
    with pytest.raises(ValueError, match="pretrained_source is not set"):
        ExperimentManager(ConfigNode(dict(cfg, model=dict(cfg["model"], pretrained=True))), device="cpu").setup_model()
    torch.save({"conv1.weight": torch.zeros(1, 1, 1, 1)}, tmp_path / "sd.pt")
    with pytest.raises(NotImplementedError, match="no torchvision porter exists for model family 'unet'"):
        ExperimentManager(ConfigNode(dict(cfg, model=dict(cfg["model"], pretrained=True, pretrained_source=str(
            tmp_path / "sd.pt")))), device="cpu").setup_model()
    for patch in ({"training": dict(cfg["training"], profile={"enabled": True})},
                  {"training": dict(cfg["training"], checkpoint_format="orbax")},
                  {"training": dict(cfg["training"], debug_nans=True)}):
        m = ExperimentManager(ConfigNode(dict(cfg, **patch)), device="cpu")
        m.setup_model()
        m.setup_optimizer()
        if "checkpoint_format" in patch["training"]:  # the reference's orbax format (ported)
            m.setup_trainer(str(tmp_path / "orbax_run"))
            m.checkpoint_hook.save(0, is_best=False)
            assert m.checkpoint_hook.fmt == "orbax"
            assert sorted(os.listdir(m.checkpoint_hook.save_dir)) == ["checkpoint_epoch_0.json",
                                                                      "checkpoint_epoch_0.orbax"]
            continue
        # training.profile and training.debug_nans raised before the
        # training-options slice (tests/test_torch_training_hooks.py runs them)
        m.setup_trainer(str(tmp_path / "run"))
        if "profile" in patch["training"]:
            hook = m.profiler_hook
            assert hook in m.trainer._hooks and (hook.log_dir, hook.start_step, hook.num_steps) == (
                str(tmp_path / "run" / "profile"), 10, 5)
        else:
            assert m.trainer.debug_nans
    # the stock configs' msgpack, the reference's single-file format
    m = ExperimentManager(ConfigNode(dict(cfg, training=dict(cfg["training"], checkpoint_format="msgpack"))),
                          device="cpu")
    m.setup_model()
    m.setup_optimizer()
    m.setup_trainer()
    m.checkpoint_hook.save(0, is_best=False)
    assert sorted(os.listdir(m.checkpoint_hook.save_dir)) == ["checkpoint_epoch_0.json",
                                                              "checkpoint_epoch_0.msgpack"]


def test_foreign_and_missing_checkpoints(tmp_path):
    state = trained_state(ADAM, steps=1).state
    # a .msgpack loads (tests/test_torch_flax_msgpack.py holds it against
    # the JAX package), and so does an orbax one (tests/test_torch_orbax.py);
    # an .orbax directory that is no orbax checkpoint raises
    save_checkpoint(str(tmp_path / "new"), state)
    got, _ = load_checkpoint(str(tmp_path / "new"), trained_state(ADAM, steps=1, seed=1).state)
    assert all(torch.equal(a, b) for a, b in zip(got.model.parameters(), state.model.parameters()))
    os.makedirs(tmp_path / "old.orbax")
    with pytest.raises(FileNotFoundError, match=r"no _METADATA in .*old\.orbax: not a StandardCheckpointer"):
        load_checkpoint(str(tmp_path / "old"), state)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "absent"), state)
    hook = CheckpointHook(str(tmp_path / "c"))
    trainer = SegTrainer(ConfigNode({"task": {"seed": 0}}), device="cpu")
    trainer.setup(state)
    trainer.register_hooks([hook])
    assert hook.load(str(tmp_path / "absent")) == 0  # nothing there: from scratch
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        CheckpointHook(str(tmp_path / "c"), fmt="zip")


def test_param_tensors_after_load_match_a_flax_tree(tmp_path):
    """A checkpoint written from weights carried over from flax holds the
    flax values under the converter's names."""
    params = random_flax_params(JaxUNet3D(**SMALL, dtype=jnp.float32), (1,) + SMALL_SHAPE, seed=9)
    state = trained_state(ADAM, steps=0).state
    state.model.load_state_dict(unet3d_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    save_checkpoint(str(tmp_path / "w"), state, fmt="torch")
    raw = torch.load(str(tmp_path / "w.pt"), weights_only=True)
    want = unet3d_from_flax(params)
    assert set(raw["model"]) == set(want) and all(torch.equal(raw["model"][k], want[k]) for k in want)
    assert raw["step"] == 0 and "ema_params" not in raw
    # the msgpack format holds the flax tree itself
    save_checkpoint(str(tmp_path / "w"), state)
    raw = flax_msgpack.load(str(tmp_path / "w.msgpack"))
    leaves = flat_flax(params)
    assert flat_flax(raw["params"]).keys() == leaves.keys()
    assert all(np.asarray(leaves[k]).tobytes() == v.numpy().tobytes() for k, v in flat_flax(raw["params"]).items())
    assert int(raw["step"]) == 0 and "ema_params" not in raw
