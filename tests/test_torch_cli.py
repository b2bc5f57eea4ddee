"""The port's command-line entry points (multimodal_tta_tpu_torch/cli/:
train, adapt, predict) on a HECKTOR21 fixture of (16,16,16) volumes, with a
small f32 UNet3D (channels 2..32, one residual unit).

``train`` writes its run directory, the log, the composed config and the
checkpoints in the stock configs' ``checkpoint_format: msgpack``, the
reference's format (the port's ``.pt`` before that format was ported; the
test keeps its name). ``adapt``, ``predict`` and ``export_serving`` run
from a checkpoint that the JAX package's ``save_checkpoint`` wrote (the
Tent artifact's initial state holds its params bit for bit); ``adapt`` and
``predict`` are held
against what the JAX CLIs (adapt.py, predict.py) compute, called in process
through the same package functions:

  - metrics: the same keys, every value within ``ATOL`` = 1e-4, the
    tolerance of tests/test_torch_seg_eval.py (f32 forwards whose logits
    agree to about 1e-5, thresholded into the same masks);
  - exported masks: equal except at voxels whose probability lies within
    ``PROB_ATOL`` = 1e-5 of the threshold; probability and uncertainty
    volumes within ``PROB_ATOL``; ``predictions.csv`` with the same rows and
    columns.
"""

import csv
import glob
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_tta_tpu.conf import compose as jax_compose
from multimodal_tta_tpu.core import ExperimentManager as JaxExperimentManager
from multimodal_tta_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from multimodal_tta_tpu.evaluation.export import PredictionExporter as JaxPredictionExporter
from multimodal_tta_tpu.tta import TTAEngine as JaxTTAEngine
from multimodal_tta_tpu_torch.cli import CONFIG_DIR, adapt, export_serving, predict, train
from multimodal_tta_tpu_torch.data import nifti
from multimodal_tta_tpu_torch.data.synthetic import make_hecktor_fixture
from multimodal_tta_tpu_torch.models.convert import unet3d_from_flax
from multimodal_tta_tpu_torch.serving.export import load_artifact

torch.set_num_threads(2)

ATOL = 1e-4  # tests/test_torch_seg_eval.py's tolerance for the metric dicts
PROB_ATOL = 1e-5
THRESHOLD = 0.3  # configs/_global_patches/hecktor21.yaml evaluation.seg.threshold


@pytest.fixture(autouse=True)
def _restore_cwd():
    """A CLI run moves into its run directory (hydra.job.chdir: true)."""
    cwd = os.getcwd()
    yield
    os.chdir(cwd)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    manifest = make_hecktor_fixture(str(root / "data"), shape=(16, 16, 16),
                                    centers={"CHUS": 3, "CHUM": 3, "CHGJ": 3})
    return {"manifest": manifest, "root": str(root)}


def common(env, run_name):
    return [
        f"dataset.manifest_csv={env['manifest']}",
        "dataset.expected_shape=[16,16,16]",
        "dataset.val_per_center=1",
        "training.epochs=1",
        "training.batch_size=2",
        "training.eval_batch_size=2",
        "training.num_workers=0",
        "training.compute_dtype=float32",
        "training.data.transforms.image_size=[16,16,16]",
        "training.model_save_start=0",
        "training.model_save_freq=1",
        "model.channels=[2,4,8,16,32]",
        "model.num_res_units=1",
        f"task.save_dir={env['root']}/outputs",
        f"task.run_name={run_name}",
    ]


def _run_dir(env, run_name):
    runs = sorted(glob.glob(os.path.join(env["root"], "outputs", run_name, "*")))
    assert len(runs) == 1, runs
    return runs[0]


@pytest.fixture(scope="module")
def jax_weights(env):
    """The JAX manager's initial params for the CLI config, and the
    checkpoint the JAX package's ``save_checkpoint`` writes of its state
    (``.msgpack`` + sidecar: the CLIs below restore it as a user's
    JAX-trained checkpoint)."""
    argv = common(env, "weights") + ["hydra.job.chdir=false", f"hydra.run.dir={env['root']}/weights"]
    jax_m = JaxExperimentManager(jax_compose(CONFIG_DIR, "config", argv))
    jax_m.setup_model()
    jax_m.setup_optimizer()
    params = jax_m.variables["params"]
    path = os.path.join(env["root"], "weights", "source")
    jax_save_checkpoint(path, jax_m.state, {"epoch": 0})
    return {"params": params, "checkpoint": path}


def _jax_manager(env, run_name, extra):
    """What adapt.py / predict.py set up, in process, with ``params``."""
    cfg = jax_compose(CONFIG_DIR, "config", common(env, run_name) + list(extra) + [
        "hydra.job.chdir=false", f"hydra.run.dir={env['root']}/jax_{run_name}"])
    m = JaxExperimentManager(cfg)
    m.setup_model()
    return cfg, m


def _close(got, want):
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in got
           if not (math.isclose(got[k], want[k], rel_tol=0.0, abs_tol=ATOL)
                   or (math.isnan(got[k]) and math.isnan(want[k])))}
    assert not bad, bad


def test_train_cli_writes_its_run_dir_and_pt_checkpoints(env):
    history = train.main(common(env, "train") + ["evaluation.surface.enable=true"], device="cpu")
    run_dir = _run_dir(env, "train")
    assert os.getcwd() == run_dir  # hydra.job.chdir
    assert os.path.isfile(os.path.join(run_dir, "train.log"))
    with open(os.path.join(run_dir, ".hydra_equiv", "config.yaml"), encoding="utf-8") as f:
        saved = f.read()
    assert "checkpoint_format: msgpack" in saved and f"manifest_csv: {env['manifest']}" in saved
    ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    assert ckpts == ["best_model.json", "best_model.msgpack", "checkpoint_epoch_0.json", "checkpoint_epoch_0.msgpack"]
    with open(os.path.join(run_dir, "checkpoints", "best_model.json"), encoding="utf-8") as f:
        assert json.load(f)["_format"] == "msgpack"
    assert len(history["train_history"]) == 1 and np.isfinite(history["train_history"][0]["loss"])
    ev = history["eval_history"][0]
    assert np.isfinite(ev["gtvt_dc"]) and "gtvt_hd95" in ev


@pytest.mark.parametrize("episodic", [True, False], ids=["episodic", "continual"])
def test_adapt_cli_matches_the_reference(env, jax_weights, episodic):
    extra = ["tta=tent", "tta.steps=1", "tta.report_no_adapt=true", f"tta.episodic={str(episodic).lower()}",
             "tta.update_path_regex=^(dec0|up0|enc0)"]
    run = f"adapt_{episodic}"
    got = adapt.main(common(env, run) + extra + [f"training.resume={jax_weights['checkpoint']}"], device="cpu")
    with open(os.path.join(_run_dir(env, run), "tta_metrics.json"), encoding="utf-8") as f:
        assert json.load(f) == json.loads(json.dumps(got))

    cfg, m = _jax_manager(env, run, extra)
    test_loader = m.setup_test_data()
    m.setup_optimizer()
    m.state = m.state.replace(params=jax_weights["params"])
    device_transform = m._builder.build_transform("test").device_spec()
    engine = JaxTTAEngine(cfg, mesh=m.mesh, device_transform=device_transform)
    with m.mesh:
        want = {"no_adapt": engine.strategy.evaluate_epoch(m.state, test_loader, m.mesh),
                "adapted": engine.evaluate(m.state, test_loader)}
    assert got.keys() == want.keys() == {"no_adapt", "adapted"}
    for k in want:
        _close(got[k], want[k])
    assert "gtvt_dc" in got["adapted"] and "dom/CHUS/avg_dc" in got["adapted"]
    assert got["adapted"] != got["no_adapt"]  # the adaptation moved the metrics


def _read_csv(path):
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.mark.parametrize("extra", [
    ["tta=tent", "tta.episodic=false", "predict.save_prob=true"],
    ["predict.split=val", "predict.save_prob=true", "predict.save_uncertainty=true", "evaluation.flip_tta.enable=true"],
], ids=["tent_continual", "val_flip_uncertainty"])
def test_predict_cli_matches_the_reference(env, jax_weights, extra):
    run = "predict_" + ("tent" if "tta=tent" in extra else "val")
    out_dir = os.path.join(env["root"], f"{run}_masks")
    rows = predict.main(common(env, run) + extra + [f"training.resume={jax_weights['checkpoint']}",
                                                     f"predict.out_dir={out_dir}"], device="cpu")
    assert {r["status"] for r in rows} == {"ok"}

    cfg, m = _jax_manager(env, run, extra)
    m.setup_optimizer()
    split = cfg.predict.split if "split" in cfg.get("predict", {}) else "test"
    if split == "test":
        loader = m.setup_test_data()
    else:
        m.setup_data("train")
        loader = m.val_loader
    m.state = m.state.replace(params=jax_weights["params"])
    engine = JaxTTAEngine(cfg, mesh=m.mesh, device_transform=m._builder.build_transform(split).device_spec())
    adapt_fn = engine.adapter.make_adapt_fn(m.state) if engine.adapter is not None else None
    want_dir = os.path.join(env["root"], f"{run}_jax_masks")
    exporter = JaxPredictionExporter(engine.strategy, want_dir, save_prob=True,
                                     save_uncertainty="predict.save_uncertainty=true" in extra)
    with m.mesh:
        want_rows = exporter.run(m.state, loader, mesh=m.mesh, adapt_fn=adapt_fn,
                                 carry_state=engine.adapter is not None and not engine.episodic)

    got_header, got_csv = _read_csv(os.path.join(out_dir, "predictions.csv"))
    want_header, want_csv = _read_csv(os.path.join(want_dir, "predictions.csv"))
    assert got_header == want_header
    assert len(got_csv) == len(want_csv) == len(rows) == len(want_rows) == (3 if split == "test" else 2)
    n_near = 0
    for got_row, want_row in zip(got_csv, want_csv):
        g, w = dict(zip(got_header, got_row)), dict(zip(want_header, want_row))
        mask, want_mask = (nifti.load(os.path.join(d, r["files"])) for d, r in ((out_dir, g), (want_dir, w)))
        prob = nifti.load(os.path.join(out_dir, g["prob_file"])).get_fdata(np.float32)
        want_prob = nifti.load(os.path.join(want_dir, w["prob_file"])).get_fdata(np.float32)
        np.testing.assert_allclose(prob, want_prob, rtol=0, atol=PROB_ATOL)
        np.testing.assert_array_equal(mask.affine, want_mask.affine)
        a, b = np.asarray(mask.dataobj), np.asarray(want_mask.dataobj)
        assert a.dtype == b.dtype == np.uint8
        differ = a != b
        assert np.all(np.abs(want_prob[differ] - THRESHOLD) <= PROB_ATOL)
        n_near += int(differ.sum())
        np.testing.assert_array_equal(a, (prob >= THRESHOLD).astype(np.uint8))
        for key in ("case_id", "domain", "status", "files", "prob_file", "uncert_file"):
            assert g.get(key) == w.get(key), key
        if n_near == 0:
            assert g["voxels_gtvt"] == w["voxels_gtvt"]
        if "uncert_file" in g:
            unc = nifti.load(os.path.join(out_dir, g["uncert_file"])).get_fdata(np.float32)
            want_unc = nifti.load(os.path.join(want_dir, w["uncert_file"])).get_fdata(np.float32)
            np.testing.assert_allclose(unc, want_unc, rtol=0, atol=PROB_ATOL)
            assert math.isclose(float(g["mean_uncert_in_pred"]), float(w["mean_uncert_in_pred"]),
                                rel_tol=0, abs_tol=PROB_ATOL)
    assert n_near <= 2


def test_export_serving_restores_the_jax_checkpoint(env, jax_weights):
    """``cli.export_serving`` from the checkpoint the JAX package wrote: the
    Tent artifact's initial state holds its params bit for bit."""
    path = os.path.join(env["root"], "jax_tent.mttap")
    export_serving.main(common(env, "export") + ["tta=tent", f"training.resume={jax_weights['checkpoint']}",
                                                 "+export.batch_size=2", f"+export.path={path}"], device="cpu")
    art = load_artifact(path, "cpu")
    names = [a["name"] for a in art.meta["args"][:art.n_state]]
    got = {n.split(":", 1)[1]: t for n, t in zip(names, art.initial_state()) if n.startswith("param:")}
    want = unet3d_from_flax(jax.tree_util.tree_map(np.asarray, jax_weights["params"]))
    assert got and all(torch.equal(t, want[k]) for k, t in got.items())


def test_cli_raises_what_is_not_there(env):
    if not torch.cuda.is_available():
        for cli in (train, adapt, predict):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cli.main(common(env, "nocard"))
    with pytest.raises(ValueError, match="No rows land in split 'val'"):
        predict.main(common(env, "noval") + ["predict.split=val", "dataset.val_per_center=0"], device="cpu")


def test_chip_smoke_cli_phase_runs_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 14 at fixture size on the CPU: every check it
    makes that holds on any device (the kernel launch counts are the card's)."""
    small = ["dataset.expected_shape=[16,16,16]", "training.data.transforms.image_size=[16,16,16]",
             "model.channels=[2,4,8,16,32]", "model.num_res_units=1", "training.compute_dtype=float32",
             "training.batch_size=2", "training.eval_batch_size=2", "training.num_workers=2"]
    out = chip_smoke.cli_phase("cpu", str(tmp_path / "cli"), shape=(16, 16, 16),
                               centers={"CHUS": 2, "CHUM": 5, "CHGJ": 5}, extra=small)
    assert out["train"]["steps"] == out["train_device_cache"]["steps"] == 6
    assert out["train_device_cache"]["batches_bitwise_host_loader"]
    assert out["train_device_cache"]["store_bytes"] == 6 * (16 ** 3 * 2 * 2 + 16 ** 3)
    assert out["adapt"]["model_restored"] and out["predict"]["model_restored"]
    assert out["predict"]["cases"] == 2 and out["decodes"]["python"] == 0
