"""The port's BatchNorm (multimodal_tta_tpu_torch/models/layers.py:BatchNorm)
against flax's ``nn.BatchNorm`` as the reference builds it (momentum 0.9,
``use_fast_variance``, f32 statistics), and its training, evaluation and
checkpoint paths: the UNet3D with ``norm=BATCH``, ``SegTrainer`` step for
step against the JAX trainer with remat off and on, EMA evaluation on the
live running statistics, a resume with its buffers.

Tolerances (f32 unless stated):
  - BatchNorm alone: outputs within 1e-5 absolute (values of order 1); in
    bf16 within 2^-7 relative of each value (one bf16 rounding of the same
    f32 result) plus 1e-6; running statistics within 1e-5 of each tensor's
    largest value (tests/_torch_port.py:assert_stats_close says why not
    elementwise);
  - UNet3D logits within 1e-5 relative L2 (bf16: 2e-2, the two packages'
    convolutions round at other places), running statistics as above;
  - SegTrainer: the loss within 2e-5 relative, params within 1e-5 relative
    + 2e-6 absolute (tests/test_torch_seg_trainer.py), running statistics
    as above; remat on and off equal within 1e-6 relative.
The UNet3D cases use the SMALL model on [2, 8, 16, 16, 2] batches
(tests/_torch_port.py:bn_unet_variables says why not the dryrun size).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import tests.test_torch_checkpoint as tck
import tests.test_torch_seg_trainer as tst
from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core import optim as joptim
from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
from multimodal_tta_tpu.core.trainers.seg_trainer import SegTrainer as JaxSegTrainer
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core import optim as toptim
from multimodal_tta_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
from multimodal_tta_tpu_torch.data import HostLoader
from multimodal_tta_tpu_torch.evaluation.seg_eval import SegmentationEvaluationStrategy
from multimodal_tta_tpu_torch.models import layers as tl
from multimodal_tta_tpu_torch.models.convert import variables_from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.models.layers import has_batch_statistics
from tests._torch_port import DEVICE_TRANSFORM, SMALL, SMALL_SHAPE, assert_stats_close, bn_unet_variables

torch.set_num_threads(2)

SHAPES = {1: (6, 5), 2: (4, 5, 6, 3), 3: (3, 4, 5, 6, 3)}  # [B, (spatial...), C], channels last


def _x(ndim: int, seed: int, padded: int = 1) -> np.ndarray:
    """A batch with a nonzero mean and ``padded`` all-zero rows at its end
    (a padded batch tail: they pool into the statistics, as in the reference)."""
    x = np.random.RandomState(seed).randn(*SHAPES[ndim]).astype(np.float32) * 1.5 + 0.7
    x[x.shape[0] - padded:] = 0.0
    return x


def _channels_first(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).movedim(-1, 1)


def _flax_bn(eps: float, use_bias: bool = True, dtype=None):
    return fnn.BatchNorm(momentum=0.9, epsilon=eps, use_bias=use_bias, dtype=dtype)


def _variables(c: int, seed: int, use_bias: bool = True):
    rng = np.random.RandomState(seed)
    params = {"scale": (1.0 + 0.2 * rng.randn(c)).astype(np.float32)}
    if use_bias:
        params["bias"] = (0.3 * rng.randn(c)).astype(np.float32)
    stats = {"mean": (0.5 * rng.randn(c)).astype(np.float32), "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return {"params": params, "batch_stats": stats}


def _port_bn(v, eps: float, use_bias: bool = True) -> tl.BatchNorm:
    m = tl.BatchNorm(len(v["params"]["scale"]), epsilon=eps, use_bias=use_bias)
    m.load_state_dict(variables_from_flax(v), strict=True)
    return m.eval()


@pytest.mark.parametrize("eps", [1e-5, 1e-3], ids=["eps1e-5", "eps1e-3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("ndim", [1, 2, 3], ids=["1d", "2d", "3d"])
def test_batch_norm_matches_flax(ndim, train, dtype, eps):
    """Output, and in training the running statistics after the forward,
    against ``flax.linen.BatchNorm(use_running_average=not train)``."""
    x = _x(ndim, seed=ndim)
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    v = _variables(x.shape[-1], seed=ndim + 10)
    out = _flax_bn(eps, dtype=jdt).apply(v, jnp.asarray(x, jdt), use_running_average=not train,
                                         mutable=["batch_stats"] if train else False)
    want = np.asarray((out[0] if train else out).astype(jnp.float32))
    m = _port_bn(v, eps)
    m.train(train)
    with torch.no_grad():
        y = m(_channels_first(x).to(tdt))
    assert y.dtype == tdt
    got = y.float().movedim(1, -1).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    stats = dict(m.named_buffers())
    if train:
        new = variables_from_flax({"params": v["params"], "batch_stats": out[1]["batch_stats"]})
        assert assert_stats_close(stats, new) == 2
    else:
        assert all(torch.equal(stats[k], torch.from_numpy(v["batch_stats"][k])) for k in ("mean", "var"))


def test_bnneck_relu_and_the_statistics_helpers():
    """``use_bias=False`` (the ResNet BNNeck) and the fused ReLU against
    flax; ``frozen_statistics`` normalizes by the batch and moves nothing;
    ``batch_statistics`` trains for the block and puts the mode back;
    ``running_statistics`` / ``load_running_statistics`` round trip."""
    x = _x(1, seed=3)
    v = _variables(x.shape[-1], seed=4, use_bias=False)
    (want, upd) = _flax_bn(1e-5, use_bias=False).apply(v, jnp.asarray(x), use_running_average=False,
                                                       mutable=["batch_stats"])
    m = _port_bn(v, 1e-5, use_bias=False)
    assert sorted(n for n, _ in m.named_parameters()) == ["scale"]
    before = tl.running_statistics(m)
    with torch.no_grad(), tl.batch_statistics(m, update=False):
        assert m.training
        frozen = m(_channels_first(x), relu=True)
    assert not m.training and all(torch.equal(t, before[k]) for k, t in tl.running_statistics(m).items())
    np.testing.assert_allclose(frozen.numpy(), np.maximum(np.asarray(want), 0.0), atol=1e-5)
    with torch.no_grad(), tl.batch_statistics(m):
        m(_channels_first(x))
    assert_stats_close(dict(m.named_buffers()), variables_from_flax({"params": v["params"], **upd}))
    tl.load_running_statistics(m, before)
    assert all(torch.equal(t, before[k]) for k, t in tl.running_statistics(m).items())
    assert has_batch_statistics(m) and not has_batch_statistics(torch.nn.Linear(2, 2))


def test_f64_input_keeps_f64_statistics():
    """flax promotes the statistics to at least f32, so an f64 input keeps
    f64 (the port's f64 reference runs rely on it): one update equals
    ``0.9 * running + 0.1 * (mean, biased var)`` to f64 rounding."""
    x = _x(2, seed=5).astype(np.float64)
    src = {k: a.astype(np.float64) for k, a in _variables(x.shape[-1], seed=6)["batch_stats"].items()}
    m = _port_bn(_variables(x.shape[-1], seed=6), 1e-5).double()
    m.train()
    with torch.no_grad():
        y = m(_channels_first(x))
    xc = x.reshape(-1, x.shape[-1])
    mean, var = xc.mean(0), (xc * xc).mean(0) - xc.mean(0) ** 2
    assert y.dtype == torch.float64
    np.testing.assert_allclose(m.mean.numpy(), 0.9 * src["mean"] + 0.1 * mean, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(m.var.numpy(), 0.9 * src["var"] + 0.1 * var, rtol=1e-12)


# ---- the UNet3D with norm BATCH ----------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bn_unet3d_forward(train, dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    v = bn_unet_variables(7)
    x = np.random.RandomState(8).randn(2, *SMALL_SHAPE).astype(np.float32)
    jm = JaxUNet3D(**SMALL, norm="BATCH", dtype=jdt)
    out = jm.apply(v, jnp.asarray(x), train=train, mutable=["batch_stats"] if train else False)
    want = np.asarray(out[0] if train else out, np.float32)
    m = UNet3D(**SMALL, norm="BATCH", dtype=tdt, device="cpu")
    m.load_state_dict(variables_from_flax(v), strict=True)
    assert has_batch_statistics(m) and len(tl.running_statistics(m)) == 20
    m.train(train)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= (1e-5 if dtype == "float32" else 2e-2), rel
    if train:
        new = variables_from_flax({"params": v["params"], "batch_stats": out[1]["batch_stats"]})
        assert assert_stats_close(m.state_dict(), new, rel=1e-5 if dtype == "float32" else 1e-2) == 20


# ---- SegTrainer with running statistics ----------------------------------------
CASES = {"sgd": {"optimizer": "sgd", "optimizers": {"sgd": {"lr": 0.01, "momentum": 0.9, "weight_decay": 1e-3}}},
         "adam_ema": {"optimizer": "adam", "optimizers": {"adam": {"lr": 1e-3, "weight_decay": 5e-4}},
                      "ema": {"enabled": True, "decay": 0.8}}}


def _jax_trainer(cfg: dict, v, remat: bool):
    jcfg = JaxConfigNode(cfg)
    trainer = JaxSegTrainer(jcfg, mesh=None, device_transform=DEVICE_TRANSFORM)
    module = JaxUNet3D(**SMALL, norm="BATCH", dtype=jnp.float32, remat=remat)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    tx, lr = joptim.build_optimizer(jcfg.training, params)
    trainer.setup(JaxTrainState.create(apply_fn=module.apply, params=params, tx=tx,
                                       batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"])),
                  None, joptim.EpochScheduler(jcfg.training, lr))
    return trainer


def _port_trainer(cfg: dict, v, remat: bool) -> SegTrainer:
    pcfg = ConfigNode(cfg)
    trainer = SegTrainer(pcfg, device_transform=DEVICE_TRANSFORM, device="cpu")
    model = UNet3D(**SMALL, norm="BATCH", dtype=torch.float32, remat=remat, device="cpu")
    model.load_state_dict(variables_from_flax(v), strict=True)
    optimizer, lr = toptim.build_optimizer(pcfg.training, model)
    trainer.setup(TrainState(model=model, optimizer=optimizer), None, toptim.EpochScheduler(pcfg.training, lr))
    return trainer


@pytest.mark.parametrize("case", sorted(CASES))
def test_seg_trainer_steps_match_reference_with_and_without_remat(case):
    """Three steps of the JAX trainer and of the port's with remat off and
    on (every level): the loss, the params and the running statistics after
    each step; the statistics move once a step with remat as without."""
    cfg = tst.config(CASES[case])
    v = bn_unet_variables(9)
    jt = _jax_trainer(cfg, v, remat=False)
    plain, remat = _port_trainer(cfg, v, remat=False), _port_trainer(cfg, v, remat=True)
    adam = cfg["training"]["optimizer"] == "adam"
    for i, batch in enumerate(tst.batches(3, seed=20)):
        for t in (jt, plain, remat):
            t.run_step(batch)
        want = jt.flush_step_metrics()["loss"]
        for t in (plain, remat):
            np.testing.assert_allclose(t.flush_step_metrics()["loss"], want, rtol=tst.LOSS_RTOL)
        stats = variables_from_flax({"params": jt.state.params, "batch_stats": jt.state.batch_stats})
        atol = tst.PARAM_ATOL * (i + 2 if adam else 1)
        for t in (plain, remat):
            tst.assert_params_close(dict(t.state.model.named_parameters()), jt.state.params, atol, f"step {i}")
            assert assert_stats_close(t.state.model.state_dict(), stats) == 20
        a, b = plain.state.model.state_dict(), remat.state.model.state_dict()
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    assert not plain.state.model.training and not remat.state.model.training


def test_tent_step_with_remat_replays_the_training_mode():
    """A Tent step on a BATCH model leaves training mode before its
    backward; the remat recompute runs in the mode of the forward (the
    batch's statistics), moves nothing, and the step equals the one
    without remat: params and running statistics."""
    from multimodal_tta_tpu_torch.tta import TentAdapter

    v = bn_unet_variables(14)
    x = torch.from_numpy(np.random.RandomState(15).randn(2, *SMALL_SHAPE).astype(np.float32) * 100)
    cfg = ConfigNode({"training": {"criterion": {"sigmoid": True}},
                      "tta": {"steps": 2, "lr": 5e-2, "momentum": 0.9, "episodic": True}})
    got = {}
    for remat in (False, True):
        m = UNet3D(**SMALL, norm="BATCH", remat=remat, device="cpu")
        m.load_state_dict(variables_from_flax(v), strict=True)
        ad = TentAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device="cpu")
        ad.make_adapt_fn(m)(m, x, 2)
        assert not m.training
        got[remat] = m.state_dict()
    for k, t in got[False].items():
        np.testing.assert_allclose(got[True][k].numpy(), t.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    moved = [k for k, t in got[True].items() if not torch.equal(t, variables_from_flax(v)[k])]
    assert sum(k.endswith((".mean", ".var")) for k in moved) == 20


def test_ema_evaluation_reads_the_live_statistics():
    """``eval_state()`` under ``training.ema.eval`` carries the EMA params
    and the LIVE running statistics, also on a later call that reuses the
    shadow module (the reference swaps only ``params``); evaluation on it
    equals evaluation of the live model with the EMA params swapped in."""
    cfg = tst.config(dict(CASES["adam_ema"], eval_test={"every_n_epochs": 1}),
                     dataset={"modality_order": ["ct", "pt"]},
                     evaluation={"seg": {"region_order": ["gtvt"], "threshold": 0.3, "spacing": [3.0, 1.0, 1.0]},
                                 "loss": {"report_loss": True}})
    pt = _port_trainer(cfg, bn_unet_variables(10), remat=False)
    model = pt.state.model
    img, lbl = tst.make_volumes(2, seed=21)
    loader = HostLoader([{"image": img[i], "label": lbl[i], "domain": "CHUM"} for i in range(2)], batch_size=2,
                        num_workers=0)
    strategy = SegmentationEvaluationStrategy(ConfigNode(cfg))
    for rounds in range(2):
        for batch in tst.batches(2, seed=22 + rounds):
            pt.run_step(batch)
        shadow = pt.eval_state()
        assert shadow is not model
        live = dict(model.named_buffers())
        for k, b in shadow.named_buffers():
            assert torch.equal(b, live[k]), k
        for n, p in shadow.named_parameters():
            assert torch.equal(p, pt.state.ema_params[n])
        got = strategy.evaluate_epoch(shadow, loader, device="cpu")
        held = {n: p.detach().clone() for n, p in model.named_parameters()}
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(pt.state.ema_params[n])
        want = strategy.evaluate_epoch(model, loader, device="cpu")
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(held[n])
        assert got == want


def test_checkpoint_round_trip_and_resume_keep_the_buffers(tmp_path):
    """The running statistics ride in the checkpoint and come back bitwise;
    a resumed BATCH run equals an uninterrupted one bitwise, buffers
    included (tests/test_torch_checkpoint.py's resume on norm BATCH)."""
    src = _port_trainer(tst.config(CASES["sgd"]), bn_unet_variables(11), remat=False)
    for batch in tst.batches(2, seed=23):
        src.run_step(batch)
    save_checkpoint(str(tmp_path / "c"), src.state)
    tmpl = _port_trainer(tst.config(CASES["sgd"]), bn_unet_variables(12), remat=False)
    got, _ = load_checkpoint(str(tmp_path / "c"), tmpl.state)
    tck.assert_states_equal(got, src.state)
    assert len(tl.running_statistics(got.model)) == 20

    def cfg(name, **training):
        c = tck.manager_config(str(tmp_path / name), **training)
        c["model"]["norm"] = "BATCH"
        return c

    full, _ = tck.run_manager(cfg("full"), 3)
    tck.run_manager(cfg("first"), 1)
    resumed, _ = tck.run_manager(cfg("resumed", resume=os.path.join(str(tmp_path / "first"), "checkpoints",
                                                                    "best_model")), 3)
    assert resumed.trainer.start_epoch == 1 and has_batch_statistics(resumed.state.model)
    tck.assert_states_equal(resumed.state, full.state)


# ---- chip_smoke.py's phase 18 at fixture size -----------------------------------
def test_chip_smoke_batchnorm_phase_runs_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 18 at fixture size on the CPU (f32, batch 2;
    the classifiers at 32x32): the BATCH flagship's training, remat,
    checkpoint, norm-step (against f64), evaluate and serving checks, the
    BATCH cli.train and the five cli.adapt methods, and the classifier
    checks, with the InstanceNorm calls counted by a module hook (none: on
    the card each would be a kernel launch)."""
    import chip_smoke
    from multimodal_tta_tpu_torch.data.synthetic import make_hecktor_fixture
    from tests._torch_port import NormCalls

    small = ["model.channels=[4,8,16,32,64]", "training.compute_dtype=float32", "training.batch_size=2",
             "training.eval_batch_size=2", "training.num_workers=0"]
    manifest = make_hecktor_fixture(str(tmp_path / "data"), shape=(16, 16, 16),
                                    centers={"CHUS": 2, "CHUM": 4, "CHGJ": 4}, seed=7)
    calls = NormCalls()
    try:
        flag = chip_smoke.batchnorm_flagship("cpu", str(tmp_path / "flag"), shape=(16, 16, 16), extra=small,
                                             reset_counts=calls.reset, read_counts=calls.read)
        cli = chip_smoke.batchnorm_cli("cpu", manifest, str(tmp_path / "cli"), extra=small + [
            "dataset.expected_shape=[16,16,16]", "training.data.transforms.image_size=[16,16,16]"],
            reset_counts=calls.reset, read_counts=calls.read)
        cls = chip_smoke.classifier_phase("cpu", str(tmp_path / "cls"), side=32, batch=4, classes=10,
                                          families=("resnet18", "efficientnet_b0"), family_batch=2,
                                          parity_batch=2, steps=2, reset_counts=calls.reset,
                                          read_counts=calls.read)
    finally:
        calls.remove()
    assert flag["train"]["launches"] == {"forward": 0, "backward": 0} and flag["train"]["params"] == [82, 36]
    assert flag["remat"]["stats_bitwise"] and flag["checkpoint_bitwise"]
    assert flag["norm_step"]["layers"] == 18 and flag["norm_step"]["stats_rel_vs_f64"] <= 1e-5
    assert set(flag["evaluate"]) == {tag for tag, _ in chip_smoke.BN_EVAL_RUNS}
    assert flag["edt"]["bitwise_plain"] and flag["edt"]["batches"] == 3 * len(chip_smoke.BN_EVAL_RUNS)
    assert flag["serving"]["statistics_moved"] == 36 and flag["serving"]["restored"]
    assert cli["train"]["checkpoint_buffers"] == 36
    assert {k for k in cli if k.startswith("adapt_")} == {f"adapt_{m}" for m in chip_smoke.BN_CLI_METHODS}
    assert set(cls["resnet50"]) == {"tent_bfloat16", "tent_float32", *chip_smoke.CLS_OTHER_METHODS}
    assert all(r["loaded_bitwise"] for r in cls["families"].values())
    assert all(v <= 1e-6 for v in cls["resnet50_vs_cpu"]["rel_l2"].values())  # the CPU against itself
