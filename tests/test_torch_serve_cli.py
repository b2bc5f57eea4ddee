"""The port's serving CLIs (multimodal_tta_tpu_torch/cli/export_serving.py and
serve_artifact.py) on a HECKTOR21 fixture of (16,16,16) volumes, with a small
f32 UNet3D (channels 4 and 8, one residual unit) from a port checkpoint.

``cli.export_serving`` writes an adapt artifact (continual Tent, inline
predictions) and a forward artifact; ``cli.serve_artifact`` serves the
fixture's NIfTI cases from them. Held, on the CPU (where the replayed
program runs the same operators as the live code, in the same order):

  - the adapt artifact's masks equal the live Tent loop's
    (``make_adapt_predict_fn`` on the checkpoint's model, the same batches,
    the zero-padded tail) voxel for voxel;
  - the forward artifact's masks equal ``cli.predict``'s on the same cases;
  - every row ``ok`` with uint8 masks in the source grid, an error row for
    a case that does not decode, the manifest written;
  - the dispatch watchdog fires on a stalled dispatch (``ServingArtifact.call``
    made slow), and ``--dispatch-deadline 0`` turns it off;
  - a channel count that differs from the artifact's raises;
  - chip_smoke.py's phase 19 (``serving_artifact_phase``) at fixture size.
"""

import csv
import os
import time

import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_tta_tpu_torch.cli import CONFIG_DIR, export_serving, predict, serve_artifact
from multimodal_tta_tpu_torch.conf import compose
from multimodal_tta_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
from multimodal_tta_tpu_torch.data import nifti
from multimodal_tta_tpu_torch.data.synthetic import make_hecktor_fixture
from multimodal_tta_tpu_torch.serving.export import ServingArtifact
from multimodal_tta_tpu_torch.tta.engine import TTAEngine
from multimodal_tta_tpu_torch.utils import watchdog as watchdog_mod

torch.set_num_threads(2)

SHAPE = (16, 16, 16)
SMALL = ["dataset.expected_shape=[16,16,16]", "training.data.transforms.image_size=[16,16,16]",
         "model.channels=[4,8]", "model.strides=[2]", "model.num_res_units=1",
         "training.compute_dtype=float32", "training.batch_size=2", "training.eval_batch_size=2",
         "training.num_workers=0"]
TENT = ["tta=tent", "tta.episodic=false", "tta.predict=inline", "tta.steps=2", "tta.lr=0.05"]
CHANNELS = ["ct_proc", "pt_proc"]  # make_hecktor_fixture's manifest columns
# f16 input rounding (about 1e-3 of a normalized intensity) moves a
# probability by less than this
PROB_NEAR = 1e-3


@pytest.fixture(autouse=True)
def _restore_cwd():
    """A CLI run moves into its run directory (hydra.job.chdir: true)."""
    cwd = os.getcwd()
    yield
    os.chdir(cwd)


def _overrides(env, run, *extra):
    return chip_smoke.cli_overrides(env["manifest"], os.path.join(env["root"], "runs", run), *SMALL, *extra)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The fixture (5 cases: 3 of CHUS, the test centre, and 2 of CHUM), a
    port checkpoint of random weights, and the two artifacts that
    ``cli.export_serving`` writes from it."""
    cwd = os.getcwd()
    root = str(tmp_path_factory.mktemp("serve"))
    manifest = make_hecktor_fixture(os.path.join(root, "data"), shape=SHAPE, centers={"CHUS": 3, "CHUM": 2}, seed=7)
    out = {"root": root, "manifest": manifest}
    m = ExperimentManager(compose(CONFIG_DIR, "config", _overrides(out, "weights", "hydra.job.chdir=false")),
                          device="cpu")
    m.setup_model()
    m.setup_optimizer()
    out["best"] = os.path.join(root, "weights", "best")
    save_checkpoint(out["best"], m.state, {"epoch": 0})
    out["adapt"] = os.path.join(root, "tent.mttap")
    export_serving.main(_overrides(out, "export_adapt", *TENT, f"training.resume={out['best']}",
                                   "+export.batch_size=2", f"+export.path={out['adapt']}"), device="cpu")
    out["forward"] = os.path.join(root, "forward.mttap")
    export_serving.main(_overrides(out, "export_forward", f"training.resume={out['best']}", "+export.mode=forward",
                                   "+export.batch_size=2", f"+export.path={out['forward']}"), device="cpu")
    os.chdir(cwd)
    return out


def _cases(env, centers=None):
    with open(env["manifest"], newline="", encoding="utf-8") as f:
        return [r for r in csv.DictReader(f) if centers is None or r["center_code"] in centers]


def _manifest(path, rows):
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return path


def _serve(artifact, manifest, out, *extra):
    return serve_artifact.main(["--artifact", artifact, "--manifest", manifest, "--channels", *CHANNELS,
                                "--out", out, *extra], device="cpu")


def _mask(out_dir, case_id):
    img = nifti.load(os.path.join(out_dir, f"{case_id}_pred.nii.gz"))
    return img


def test_adapt_artifact_serves_like_the_live_tent_loop(env, tmp_path):
    out_dir = str(tmp_path / "served")
    rows = _serve(env["adapt"], env["manifest"], out_dir, "--seed", "0")
    cases = _cases(env)
    assert [r["case_id"] for r in rows] == [c["patient_id"] for c in cases] and len(rows) == 5
    assert all(r["status"] == "ok" and "entropy_final" in r for r in rows)
    with open(os.path.join(out_dir, "predictions.csv"), newline="", encoding="utf-8") as f:
        assert len(list(csv.DictReader(f))) == 5
    # the live Tent loop on the checkpoint's model, as the export CLI builds it
    cfg = compose(CONFIG_DIR, "config", _overrides(env, "live", *TENT, "hydra.job.chdir=false"))
    m = ExperimentManager(cfg, device="cpu")
    m.setup_model()
    m.setup_optimizer()
    model = load_checkpoint(env["best"], m.state)[0].model
    engine = TTAEngine(cfg, device_transform=m.get_dataset_builder_for_task().build_transform("test").device_spec(),
                       device="cpu")
    fn = engine.adapter.make_adapt_predict_fn(model, float(cfg.evaluation.seg.threshold), "inline")
    for start in range(0, 5, 2):
        chunk = cases[start:start + 2]
        vols = [np.stack([nifti.load_canonical_dhw(c[k]) for k in CHANNELS], -1) for c in chunk]
        vols += [np.zeros_like(vols[0])] * (2 - len(vols))
        _, pred = fn(model, torch.from_numpy(np.stack(vols).astype(np.float32)), len(chunk))
        for i, c in enumerate(chunk):
            img = _mask(out_dir, c["patient_id"])
            affine, shape_xyz = nifti.peek_canonical_geometry(c["ct_proc"])
            assert img.dataobj.dtype == np.uint8 and tuple(img.shape) == tuple(shape_xyz)
            assert np.allclose(img.affine, affine)
            assert np.array_equal(np.asarray(img.dataobj).transpose(2, 1, 0), pred[i, ..., 0].numpy())


def test_forward_artifact_serves_like_cli_predict(env, tmp_path):
    """The test centre's cases (CHUS) through the forward artifact and
    through ``cli.predict`` (no TTA); a case that does not decode gets an
    error row and the stream goes on."""
    test_cases = _cases(env, {"CHUS"})
    rows = test_cases + [dict(test_cases[0], patient_id="missing", ct_proc="/nonexistent/ct.nii.gz")]
    out_dir = str(tmp_path / "served")
    got = _serve(env["forward"], _manifest(str(tmp_path / "m.csv"), rows), out_dir, "--threshold", "0.3")
    assert [r["status"] for r in got[:3]] == ["ok"] * 3 and got[3]["status"].startswith("error:")
    assert "entropy_final" not in got[0]
    want = predict.main(_overrides(env, "predict", f"training.resume={env['best']}", "predict.save_prob=true",
                                   f"predict.out_dir={tmp_path / 'predicted'}"), device="cpu")
    assert sorted(r["case_id"] for r in want) == sorted(c["patient_id"] for c in test_cases)
    for c in test_cases:
        a = np.asarray(_mask(out_dir, c["patient_id"]).dataobj)
        b = np.asarray(nifti.load(str(tmp_path / "predicted" / f"{c['patient_id']}_pred.nii.gz")).dataobj)
        prob = np.asarray(nifti.load(str(tmp_path / "predicted" / f"{c['patient_id']}_prob.nii.gz")).dataobj)
        # cli.predict moves its batches to the device in f16 (data/prefetch.py), the server
        # in f32: the masks may differ only where the probability sits at the threshold
        differ = a != b.astype(np.uint8)
        assert not differ.any() or np.abs(prob[differ] - 0.3).max() < PROB_NEAR


def _slow_calls(monkeypatch, seconds):
    real = ServingArtifact.call

    def slow(self, *args):
        time.sleep(seconds)  # a dispatch that hangs past the deadline, then returns
        return real(self, *args)

    monkeypatch.setattr(ServingArtifact, "call", slow)


def test_stalled_dispatch_fires_the_watchdog(env, tmp_path, monkeypatch):
    fired = {}

    class Recorder(watchdog_mod.DispatchWatchdog):
        def _fire(self):  # keep the diagnosis, skip the os._exit
            fired["msg"] = watchdog_mod.wedged_diagnosis(self.what, self._current_deadline)

    monkeypatch.setattr(watchdog_mod, "DispatchWatchdog", Recorder)
    _slow_calls(monkeypatch, 1.0)
    rows = _serve(env["forward"], _manifest(str(tmp_path / "m.csv"), _cases(env)[:1]), str(tmp_path / "out"),
                  "--dispatch-deadline", "0.2", "--first-dispatch-deadline", "0.4")
    assert fired, "the watchdog did not fire on a stalled dispatch"
    assert "serve_artifact" in fired["msg"] and "nvidia-smi" in fired["msg"]
    assert len(rows) == 1  # the recorder lets the stream finish


def test_dispatch_deadline_zero_disables_the_watchdog(env, tmp_path, monkeypatch):
    _slow_calls(monkeypatch, 0.3)
    rows = _serve(env["forward"], _manifest(str(tmp_path / "m.csv"), _cases(env)[:1]), str(tmp_path / "out"),
                  "--dispatch-deadline", "0")
    assert [r["status"] for r in rows] == ["ok"]


def test_serving_errors(env, tmp_path):
    with pytest.raises(ValueError, match="expects 2 channels"):
        serve_artifact.main(["--artifact", env["adapt"], "--manifest", env["manifest"], "--channels", "ct_proc",
                             "--out", str(tmp_path / "out")], device="cpu")
    with pytest.raises(ValueError, match="training.resume"):
        export_serving.main(_overrides(env, "noresume", *TENT), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export_serving.main(_overrides(env, "nocard", *TENT, f"training.resume={env['best']}"))


def test_chip_smoke_serving_phase_runs_on_the_cpu(env, tmp_path):
    """chip_smoke.py's phase 19 at fixture size on the CPU: every check it
    makes that holds on any device (the launch counts are the card's; the
    norm operator calls the programs hold are checked here)."""
    runs = tuple((tag, ov, n) for (tag, ov, _), n in zip(chip_smoke.SERVING_ARTIFACT_RUNS, (2, 1)))
    out = chip_smoke.serving_artifact_phase(
        "cpu", str(tmp_path / "phase19"), manifest=env["manifest"], best=env["best"], shape=SHAPE,
        model_kw={"channels": (4, 8), "strides": (2,), "num_res_units": 1, "dtype": torch.float32},
        runs=runs, methods=chip_smoke.SERVING_ARTIFACT_METHODS[:1], cli_extra=SMALL, per_forward=3)
    r = out["runs"]
    assert r["continual_inline"]["program_norm_calls"] == {"forward": 3, "backward": 3}
    assert r["episodic_post"]["program_norm_calls"] == {"forward": 6, "backward": 3}
    assert r["sar"]["program_norm_calls"] == {"forward": 6, "backward": 6} and "bytes" not in r["sar"]
    assert all(min(x["pred_agree"]) == 1.0 and max(x["ent_abs_err"]) == 0.0 for x in r.values())
    assert out["forward"]["max_abs_err"] == 0.0
    assert out["serve_cli"]["statuses"] == ["ok"] * chip_smoke.SERVE_CASES
    assert "bytes" in r["continual_inline"] and r["continual_inline"]["load_s"] > 0
    assert not os.path.exists(str(tmp_path / "phase19"))
