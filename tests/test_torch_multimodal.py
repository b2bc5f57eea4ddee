"""The BraTS recipe of train_brats.sh on the port's mid-fusion UNet, against
the JAX package on the same flax weights (small widths, channels
(4, 8, 16, 32, 64), f32, 4 modalities, 3 regions):

  - one Tent step (episodic, post-update predictions) and one with
    modality dropout (BASELINE.json config #3), the draws shared through
    ``tests/_torch_port.py:JaxDraws``: entropy 1e-5 relative, norm-param
    deltas 1e-3 relative L2, predictions on 99.9% of voxels (the tolerances
    ROADMAP.md §3 keeps);
  - with modality dropout, from the reference's draws, Tent's bounds are
    10x those: a dropped modality is an all-zero channel, whose encoder's
    norms see a field that is constant but near the borders, so their small
    variance amplifies each rounding. Measured on these inputs: the logits'
    relative L2 between the packages goes from 3.3e-6 to 3.5e-5 with one
    modality zeroed; Tent's entropy 2.0e-5, its norm deltas 5.9e-3;
  - two ``SegTrainer`` steps of the recipe (remat, multi-label DiceCE over
    ET/TC/WT), without and with modality dropout, with SGD: the loss within
    1e-4 relative and the parameter deltas within 1e-2 relative L2, 5x and
    10x tests/test_torch_seg_trainer.py's bounds for its two-level UNet3D:
    here 5 levels end in norms over 8 and 64 voxels, whose convs' weight
    gradients differ by 1-2% between the packages (a ReLU mask bit that
    flips there moves them), and their element-wise bound fails on 5 of
    27648 weights of one decoder conv;
  - ``cli.train`` then ``cli.adapt`` on a tiny ``make_brats_fixture``: the
    report's keys against the JAX CLIs' code on the same data;
  - chip_smoke.py's phase 16 at fixture size on the CPU.

Volumes are [*, 32, 32, 32, 4] where a gradient is compared: over 16^3 the
deepest of the 4 stride-2 levels is one voxel, whose variance is 0, so its
norm turns rounding noise into O(1) values (times rsqrt(eps) = 316).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.conf import compose as jax_compose
from multimodal_tta_tpu.core import ExperimentManager as JaxExperimentManager
from multimodal_tta_tpu.core import optim as joptim
from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
from multimodal_tta_tpu.core.trainers.seg_trainer import SegTrainer as JaxSegTrainer
from multimodal_tta_tpu.models.unet_multimodal_midfusion import MultimodalUNetMidFusion as JaxMid
from multimodal_tta_tpu.tta import TTAEngine as JaxTTAEngine
from multimodal_tta_tpu.tta.tent import TentAdapter as JaxTent
from multimodal_tta_tpu_torch.cli import CONFIG_DIR, adapt, train
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core import optim as toptim
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.core.trainers import seg_trainer as seg_trainer_module
from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
from multimodal_tta_tpu_torch.data.synthetic import brats_volumes, make_brats_fixture
from multimodal_tta_tpu_torch.models import MultimodalUNetMidFusion
from multimodal_tta_tpu_torch.models.convert import from_flax
from multimodal_tta_tpu_torch.tta.tent import TentAdapter, norm_param_mask
from tests._torch_port import (
    NormCalls,
    _jax_dropout,
    assert_adapted_close,
    assert_preds_close,
    random_flax_params,
    run_jax_adapter,
    run_torch_adapter,
    tta_config,
)

torch.set_num_threads(2)

MID = dict(num_modalities=4, num_classes=3, channels=(4, 8, 16, 32, 64), strides=(2, 2, 2, 2), num_res_units=2)
SHAPE = (32, 32, 32)
BRATS_TRANSFORM = {"normalize": False}  # the recipe's: raw intensities (configs/_global_patches/brats.yaml)
CRITERION = {"task": "multilabel", "lambda_dice": 1.0, "lambda_ce": 1.0, "include_background": True,
             "squared_pred": False, "jaccard": False, "sigmoid": True}
# the training steps: the loss relative, the parameter deltas relative L2
# (measured: 3.5e-5 and 4.0e-3 without dropout, 2.8e-5 and 6.3e-3 with)
LOSS_RTOL, DELTA_REL = 1e-4, 1e-2


@pytest.fixture(scope="module")
def mid_params():
    return random_flax_params(JaxMid(**MID, remat=True), (1,) + SHAPE + (4,), seed=8)


def _port_mid(params, **kw):
    m = MultimodalUNetMidFusion(**{**MID, **kw}, device="cpu")
    m.load_state_dict(from_flax(params), strict=True)
    return m


def _samples(n, seed):
    return brats_volumes(n, SHAPE, seed=seed)


@pytest.mark.parametrize("dropout,scale", [(False, 1), (True, 10)], ids=["tent", "tent_modality_dropout"])
def test_tent_step_matches_the_reference(mid_params, dropout, scale):
    """Episodic Tent, post-update predictions, on two batches of 2."""
    cfg = tta_config(modality_dropout={"enabled": dropout, "prob": 0.5})
    batches = [np.stack([s["image"] for s in _samples(2, seed)]) for seed in (3, 4)]
    j_adapted, j_ents, j_preds, _ = run_jax_adapter(JaxTent, mid_params, cfg, batches, 2, "post", threshold=0.5,
                                                    module=JaxMid(**MID, remat=True),
                                                    device_transform=BRATS_TRANSFORM)
    model = _port_mid(mid_params, remat=True)
    source = {k: v.detach().clone() for k, v in model.state_dict().items()}
    t_adapted, t_ents, t_preds, adapter = run_torch_adapter(TentAdapter, mid_params, cfg, batches, 2, "post",
                                                            threshold=0.5, model=model,
                                                            device_transform=BRATS_TRANSFORM)
    for a, b in zip(t_ents, j_ents):
        np.testing.assert_allclose(a, b, rtol=1e-5 * scale)
    names = [n for n, v in norm_param_mask(model).items() if v]
    assert len(names) == 2 * (4 * 10 + 1 + 8)  # the encoders', the one fusion norm's, the decoder's
    # episodic: the post-update state of the last batch
    assert_adapted_close(t_adapted, j_adapted, source, names, rel=1e-3 * scale)
    assert_preds_close(t_preds, j_preds)
    assert adapter.md_enabled == dropout


def _jax_trainer(cfg, params, spec):
    jcfg = JaxConfigNode(cfg)
    trainer = JaxSegTrainer(jcfg, mesh=None, device_transform=spec)
    module = JaxMid(**MID, remat=True)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx, lr = joptim.build_optimizer(jcfg.training, params)
    trainer.setup(JaxTrainState.create(apply_fn=module.apply, params=params, tx=tx), None,
                  joptim.EpochScheduler(jcfg.training, lr))
    return trainer


@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "modality_dropout"])
def test_brats_recipe_training_steps_match_the_reference(mid_params, monkeypatch, dropout):
    """Two steps of the recipe with remat on both sides, the port's
    modality dropout given the reference's draws (its key-split order: a
    step key per run_step, the dropout key split from it). SGD with
    momentum, not the recipe's adam: Adam's first update is lr * sign(g), so
    an element whose gradient sits at the noise floor flips by 2 lr (3 of
    3456 in one conv here); the optimizers are held against optax in
    tests/test_torch_optim.py."""
    spec = {"normalize": False, "modality_dropout": dropout, "modality_dropout_prob": 0.5}
    cfg = {"task": {"seed": 0}, "training": {
        "optimizer": "sgd", "optimizers": {"sgd": {"lr": 1e-2, "momentum": 0.9}}, "remat": True,
        "criterion": CRITERION,
        "param_groups": {"no_decay_keys": ["bias", "bn", "norm", "scale"], "treat_1d_as_no_decay": True}}}
    jt = _jax_trainer(cfg, mid_params, spec)
    pt = SegTrainer(ConfigNode(cfg), device_transform=spec, device="cpu")
    model = _port_mid(mid_params, remat=True)
    optimizer, lr = toptim.build_optimizer(ConfigNode(cfg).training, model)
    pt.setup(TrainState(model=model, optimizer=optimizer), None, toptim.EpochScheduler(ConfigNode(cfg).training, lr))

    key = [jax.random.PRNGKey(0)]

    def reference_draws(b, m, gen, prob):
        key[0], step_key = jax.random.split(key[0])
        _, k_md = jax.random.split(step_key)
        return _jax_dropout(k_md, b, m, prob)

    monkeypatch.setattr(seg_trainer_module, "modality_dropout_draws", reference_draws)
    source = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, seed in enumerate((5, 6)):
        samples = _samples(2, seed)
        batch = {"image": np.stack([s["image"] for s in samples]), "label": np.stack([s["label"] for s in samples])}
        jt.run_step(batch)
        pt.run_step(batch)
        want, got = jt.flush_step_metrics()["loss"], pt.flush_step_metrics()["loss"]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=f"loss of step {i}")
        ref = from_flax(jax.tree_util.tree_map(np.asarray, jt.state.params))
        params = dict(model.named_parameters())
        dj = torch.cat([(ref[n] - source[n]).flatten() for n in source])
        dt = torch.cat([(params[n].detach() - source[n]).flatten() for n in source])
        assert float((dt - dj).norm() / dj.norm()) < DELTA_REL, f"param deltas after step {i}"
    assert not model.training  # the step ran in training mode and put it back
    # no loss reaches the domain head: it stays at its source values
    assert torch.equal(model.domain_classifier.weight, from_flax(mid_params)["domain_classifier.weight"])


@pytest.fixture(scope="module")
def brats_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats_cli")
    sources = {"glipre": {"profile": "gli", "cases": {"train": 2, "test": 2}},
               "ssa": {"profile": "ssa", "cases": {"test": 2}}, "ped": {"profile": "ped", "cases": {"test": 2}}}
    csvs = make_brats_fixture(str(root / "data"), sources=sources, shape=(16, 16, 16), seed=2, n_lesions=(1, 1),
                              radius_range=(3.0, 6.0))
    return {"root": str(root), "csvs": csvs}


def _cli_args(env, run):
    return [f"dataset.sources.{i}.csv_path={env['csvs'][s]}" for i, s in enumerate(("glipre", "ssa", "ped"))] + [
        "task=brats", "dataset=brats", "model=unet_multimodal_midfusion", "dataset.expected_shape=[16,16,16]",
        "training.data.transforms.image_size=[16,16,16]", "model.channels=[4,8,16,32,64]",
        "training.compute_dtype=float32", "training.batch_size=2", "training.eval_batch_size=2",
        "training.num_workers=0", "training.epochs=1", "training.model_save_start=0", "training.remat=true",
        "evaluation.surface.enable=true", f"task.save_dir={env['root']}/outputs", f"task.run_name={run}"]


def test_train_and_adapt_clis_report_the_reference_keys(brats_env):
    """cli.train then cli.adapt with model=unet_multimodal_midfusion; the
    adapt report has the keys the JAX package computes on the same data
    (per region, per domain, the two test sources)."""
    env = brats_env
    cwd = os.getcwd()
    try:
        history = train.main(_cli_args(env, "train"), device="cpu")
        run_dir = os.getcwd()
    finally:
        os.chdir(cwd)
    assert np.isfinite(history["train_history"][0]["loss"]) and "et_hd95" in history["eval_history"][0]
    best = os.path.join(run_dir, "checkpoints", "best_model")
    extra = ["tta=tent", "tta.report_no_adapt=true"]
    try:
        got = adapt.main(_cli_args(env, "adapt") + extra + [f"training.resume={best}"], device="cpu")
    finally:
        os.chdir(cwd)

    cfg = jax_compose(CONFIG_DIR, "config", _cli_args(env, "jax") + extra + [
        "hydra.job.chdir=false", f"hydra.run.dir={env['root']}/jax"])
    m = JaxExperimentManager(cfg)
    m.setup_model()
    test_loader = m.setup_test_data()
    m.setup_optimizer()
    engine = JaxTTAEngine(cfg, mesh=m.mesh, device_transform=m._builder.build_transform("test").device_spec())
    with m.mesh:
        want = {"no_adapt": engine.strategy.evaluate_epoch(m.state, test_loader, m.mesh),
                "adapted": engine.evaluate(m.state, test_loader)}
    assert got.keys() == want.keys() == {"no_adapt", "adapted"}
    for mode in want:
        assert set(got[mode]) == set(want[mode]), mode
        assert {"dom/brats24_ssa/avg_dc", "dom/brats24_ped/avg_dc", "et_hd95", "wt_asd"} <= set(got[mode])
        assert all(np.isfinite(v) for v in got[mode].values())


def test_chip_smoke_brats_phase_runs_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 16 at fixture size on the CPU (channels
    4..64, f32): training, serving and the CLIs with every check they make,
    the norm calls counted by a module hook (on the card, each is a kernel
    launch) against what remat and the step structure derive."""
    small = ["model.channels=[4,8,16,32,64]", "training.compute_dtype=float32", "training.num_workers=0"]
    calls = NormCalls()
    try:
        out = chip_smoke.brats_train_and_serve("cpu", str(tmp_path / "serve"), shape=(16, 32, 16), extra=small,
                                               reset_counts=calls.reset, read_counts=calls.read)
        cli = chip_smoke.brats_cli("cpu", str(tmp_path / "cli"), shape=(16, 32, 16), extra=small,
                                   reset_counts=calls.reset, read_counts=calls.read)
    finally:
        calls.remove()
    t = out["train"]
    assert t["steps"] == 4 and t["val_batches"] == 2 and t["params"] == (208, 98)
    assert t["launches"] == {"forward": 4 * 104 + 2 * 52, "backward": 4 * 52}
    assert [e["shape"] for e in t["edt"]] == [[12, 16, 32, 16]] * 2
    assert set(out["tta"]) == {tag for tag, _ in chip_smoke.BRATS_TTA_RUNS}
    assert out["tta"]["none"]["launches"] == {"forward": 2 * 52, "backward": 0}
    assert out["tta"]["tent_episodic_post"]["launches"] == {"forward": 2 * (52 + 104), "backward": 2 * 52}
    assert out["tent_step"]["grad_reached"] == out["tent_step"]["norm_tensors"] == 98
    assert out["serving"]["strict"]["launches"] == {"forward": 3 * 156, "backward": 3 * 52}
    norm_keys = ("forward", "backward")
    assert cli["train"]["launches"] == {k: cli["train"]["want"][k] for k in norm_keys}
    assert cli["train"]["want"] == {"forward": 2 * 104 + 3 * 52, "backward": 2 * 52, "minplus": 3}
    assert cli["adapt"]["launches"] == {"forward": 2 * 208, "backward": 2 * 52}


def test_chip_smoke_other_models_run_on_the_cpu():
    """Phase 16's other models at fixture size: the norm calls of a forward
    (72 late fusion, 16 UNet3D-WS, none in SegResNet's GroupNorm) and of a
    Tent step, every norm tensor reached by its gradient."""
    calls = NormCalls()
    try:
        out = chip_smoke.brats_other_models("cpu", (16, 32, 16), channels=(4, 8, 16, 32, 64), init_filters=8,
                                            reset_counts=calls.reset, read_counts=calls.read)
    finally:
        calls.remove()
    # UNet3D-WS's stem projects 32 packed channels to 4 here (70 tensors at
    # full width, where they already number 32)
    for name, per_forward, params in (("unet_multimodal_late", 72, 328), ("unet_ws", 16, 72), ("segresnet", 0, 83)):
        r = out[name]
        assert r["launches_per_forward"] == {"forward": per_forward, "backward": 0}, name
        assert r["tent_step_launches"] == {"forward": per_forward, "backward": per_forward}, name
        assert r["grad_reached"] == r["norm_tensors"] > 0 and r["params"] == params, name
        assert r["finite"] and r["logits"] == [1, 16, 32, 16, 3] and r["logits_rel_l2_plain"] == 0.0
