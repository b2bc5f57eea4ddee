"""Parity of the port's preprocessing CLIs (multimodal_tta_tpu_torch/cli/
prepare_hecktor21.py, prepare_brats.py) with the JAX scripts
(scripts/prepare_hecktor21.py, prepare_brats.py), both run in process on the
same raw NIfTI files, written from seeds by chip_smoke.py's fixture writers.

Tolerances: labels equal voxel for voxel; linear images within 1e-5 of the
data's range (the resampler's, tests/test_torch_resample.py); affines, dtypes
and manifest rows (read back with ``pandas.read_csv``, the output directory
taken out of the paths) equal; the split goldens of
tests/test_resample_preprocess.py exactly."""

import importlib
import os
import sys

import numpy as np
import pandas as pd
import pytest
import yaml

import chip_smoke
from multimodal_tta_tpu.data import nifti as jnifti
from multimodal_tta_tpu_torch.cli import prepare_brats, prepare_hecktor21
from multimodal_tta_tpu_torch.data import nifti

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINEAR_REL = 1e-5
SMALL = dict(ct=((40, 40, 12), (2.93, 2.93, 3.0)), pt=((18, 18, 12), (8.14, 8.14, 3.0)), bbox_mm=45.0)
SMALL_GEOMETRY = dict(spacing=(3.0, 3.0, 3.0), output=(16, 16, 16))
CENTERS = {"CHGJ": 2, "CHUS": 2, "CHUP": 2, "XXXX": 1}


@pytest.fixture(scope="module")
def jax_scripts():
    """The JAX scripts as modules (their imports set JAX's platform)."""
    sys.path.insert(0, os.path.join(REPO_ROOT, "scripts"))
    try:
        return importlib.import_module("prepare_hecktor21"), importlib.import_module("prepare_brats")
    finally:
        sys.path.pop(0)


def _run_jax(mod, monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", [mod.__file__, *args])
    mod.main()


def _write(path, cfg) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _hecktor_configs(tmp_path, raw, **kw):
    """The same config for both packages, each with its own output root."""
    cfgs = {}
    for side in ("port", "jax"):
        cfg = chip_smoke.hecktor_prep_config(raw, str(tmp_path / side), **SMALL_GEOMETRY)
        cfg.update(kw)
        cfgs[side] = (cfg, _write(tmp_path / f"{side}.yaml", cfg))
    return cfgs


def _frame(path, root) -> pd.DataFrame:
    """A manifest read back with pandas, ``root`` taken out of its paths."""
    df = pd.read_csv(path)
    for c in df.columns:
        if not pd.api.types.is_numeric_dtype(df[c]):
            df[c] = df[c].map(lambda v: v.replace(str(root), "<out>") if isinstance(v, str) else v)
    return df


def _assert_volumes(port_path, jax_path, label: bool):
    a, b = nifti.load(port_path), jnifti.load(jax_path)
    va, vb = np.asarray(a.dataobj), np.asarray(b.dataobj)
    assert va.dtype == vb.dtype and va.shape == vb.shape
    np.testing.assert_array_equal(a.affine, b.affine)
    if label:
        np.testing.assert_array_equal(va, vb)
    else:
        np.testing.assert_allclose(va, vb, rtol=0, atol=LINEAR_REL * float(np.ptp(vb)))


@pytest.fixture
def hecktor_raw(tmp_path):
    raw = chip_smoke.write_raw_hecktor(str(tmp_path / "raw"), centers=CENTERS, **SMALL)
    os.remove(os.path.join(raw["nii_root"], "CHUS002_pt.nii"))  # a missing_file row
    with open(os.path.join(raw["nii_root"], "CHGJ002_gtvt.nii"), "wb") as f:  # an error:<type> row
        f.write(b"not a nifti file")
    return raw


def test_hecktor_cli_matches_reference(tmp_path, monkeypatch, jax_scripts, hecktor_raw):
    cfgs = _hecktor_configs(tmp_path, hecktor_raw)
    res = prepare_hecktor21.main(["--config", cfgs["port"][1]], device="cpu")
    _run_jax(jax_scripts[0], monkeypatch, "--config", cfgs["jax"][1], "--mode", "full")

    for name in ("manifest.csv", "source.csv", "target.csv"):
        got = _frame(tmp_path / "port" / name, tmp_path / "port")
        want = _frame(tmp_path / "jax" / name, tmp_path / "jax")
        pd.testing.assert_frame_equal(got, want)
    mf = pd.read_csv(tmp_path / "port" / "manifest.csv")
    assert list(mf["status"]) == ["ok", "error:ValueError", "ok", "missing_file", "ok", "ok"]
    assert "XXXX001" not in set(mf["patient_id"])
    assert [r["patient_id"] for r in res["rows"]] == list(mf["patient_id"])
    assert sorted(res["part_ms"]) == sorted(mf[mf["status"] == "ok"]["patient_id"])
    assert all(sorted(ms) == sorted(prepare_hecktor21.PARTS) for ms in res["part_ms"].values())
    ok = mf[mf["status"] == "ok"]
    assert len(ok) == 4 and (ok["final_output_size"] == "16,16,16").all()
    for _, row in ok.iterrows():
        for m in ("ct", "pt", "gtvt"):
            _assert_volumes(row[f"{m}_proc"], row[f"{m}_proc"].replace(str(tmp_path / "port"), str(tmp_path / "jax")),
                            label=m == "gtvt")
        gt = np.asarray(nifti.load(row["gtvt_proc"]).dataobj)
        assert gt.dtype == np.uint8 and set(np.unique(gt)) <= {0, 1} and gt.sum() > 0


def test_process_case_flipped_ct_rotated_pet_matches_reference(tmp_path, jax_scripts):
    """One case by each package's ``process_case``: a CT whose x axis runs the
    other way and a PET rotated against it, on the CPU."""
    rng = np.random.RandomState(7)
    ct_aff = np.diag([2.5, -2.5, 3.0, 1.0])
    ct_aff[:3, 3] = [-40.0, 45.0, -20.0]
    a = np.deg2rad(9.0)
    rot = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
    pt_aff = np.eye(4)
    pt_aff[:3, :3] = rot @ np.diag([-6.0, -6.0, 3.0])
    pt_aff[:3, 3] = [30.0, 35.0, -18.0]
    ct = (rng.rand(32, 36, 14) * 2000 - 1000).astype(np.float32)
    pt = (rng.rand(14, 14, 14) * 10).astype(np.float32)
    gt = np.zeros((32, 36, 14), np.uint8)
    gt[10:20, 12:22, 4:9] = 1
    raw = tmp_path / "raw"
    for name, (v, aff) in {"ct": (ct, ct_aff), "pt": (pt, pt_aff), "gtvt": (gt, ct_aff)}.items():
        nifti.save(v, aff, str(raw / f"P_{name}.nii.gz"))
    r = {"x1": -30.0, "x2": 10.0, "y1": -35.0, "y2": 5.0, "z1": -30.0, "z2": 12.0}  # z below the CT: padded
    cfg = {"target_spacing": [2.0, 2.0, 3.0], "output_size": [16, 20, 8], "interp_pt": "linear"}
    geo = prepare_hecktor21.geometry_config(cfg)  # the dict the JAX script's main builds from cfg
    rows, ms = {}, {}
    for side, mod in (("port", prepare_hecktor21), ("jax", jax_scripts[0])):
        out = tmp_path / side
        for d in ("images", "labels"):
            (out / d).mkdir(parents=True)
        paths = (raw / "P_ct.nii.gz", raw / "P_pt.nii.gz", raw / "P_gtvt.nii.gz", out / "images", out / "labels")
        kw = {"device": "cpu", "part_ms": ms} if side == "port" else {}
        rows[side] = mod.process_case("P", r, geo, paths, **kw)
    assert sorted(ms) == sorted(prepare_hecktor21.PARTS)
    norm = {side: {k: os.path.basename(v) if k.endswith("_proc") else v for k, v in row.items()}
            for side, row in rows.items()}
    assert norm["port"] == norm["jax"]
    assert rows["port"]["pad_ct_before"] != "0,0,0" or rows["port"]["pad_ct_after"] != "0,0,0"
    for m in ("ct", "pt", "gtvt"):
        _assert_volumes(rows["port"][f"{m}_proc"], rows["jax"][f"{m}_proc"], label=m == "gtvt")


GOLDEN_IDS = [f"{c}{i:03d}" for c in ["CHGJ", "CHUS", "CHUM", "CHUP", "CHMR", "XXXX"] for i in range(7)]


@pytest.mark.parametrize("case", ["seed_2026", "other_policy_source", "disabled", "capped"])
def test_split_goldens(case, jax_scripts):
    """tests/test_resample_preprocess.py's goldens, and the JAX function's
    whole frame, from the port's ``assign_splits``."""
    frame = pd.DataFrame({"patient_id": GOLDEN_IDS, "center_code": [i[:4] for i in GOLDEN_IDS]})
    args = {"seed_2026": (True, ["CHGJ", "CHUS", "CHUM"], ["CHUP", "CHMR"], 2, 2026, "ignore"),
            "other_policy_source": (True, ["CHGJ"], ["CHUS"], 3, 7, "source"),
            "disabled": (False, [], [], 0, 0, "ignore"),
            "capped": (True, ["CHGJ"], [], 5, 0, "ignore")}[case]
    if case == "capped":
        frame = pd.DataFrame({"patient_id": ["CHGJ000", "CHGJ001"], "center_code": ["CHGJ", "CHGJ"]})
    rows = prepare_hecktor21.assign_splits(frame.to_dict("records"), *args)
    assert rows == jax_scripts[0].assign_splits(frame, *args).to_dict("records")
    out = pd.DataFrame(rows)
    val = [r.patient_id for r in out.itertuples() if r.split == "val"]
    if case == "seed_2026":
        assert val == ["CHGJ004", "CHGJ005", "CHUS005", "CHUS006", "CHUM000", "CHUM002"]
        assert (out[out.center_code.isin(["CHUP", "CHMR"])]["split"] == "test").all()
        assert (out[out.center_code == "XXXX"]["split"] == "ignore").all()
    elif case == "other_policy_source":
        assert val == ["CHGJ000", "CHGJ002", "CHGJ005", "CHUM001", "CHUM002", "CHUM005", "CHUP001", "CHUP004",
                       "CHUP005", "CHMR003", "CHMR004", "CHMR005", "XXXX001", "XXXX002", "XXXX004"]
    elif case == "disabled":
        assert (out["domain"] == "all").all() and (out["split"] == "train").all()
    else:
        assert (out["split"] == "val").all()


def test_split_only_mode_matches_reference(tmp_path, monkeypatch, jax_scripts, hecktor_raw):
    cfgs = _hecktor_configs(tmp_path, hecktor_raw)
    res = prepare_hecktor21.main(["--config", cfgs["port"][1], "--mode", "split_only"], device="cpu")
    _run_jax(jax_scripts[0], monkeypatch, "--config", cfgs["jax"][1], "--mode", "split_only")
    for name in ("manifest.csv", "source.csv", "target.csv"):
        pd.testing.assert_frame_equal(_frame(tmp_path / "port" / name, tmp_path / "port"),
                                      _frame(tmp_path / "jax" / name, tmp_path / "jax"))
    assert len(res["rows"]) == 6 and res["part_ms"] == {}
    assert not os.listdir(tmp_path / "port" / "images")  # no voxel read or written


def test_hecktor_pool_equals_serial(tmp_path, hecktor_raw):
    cfgs = {}
    for tag in ("w1", "w2"):
        cfg = chip_smoke.hecktor_prep_config(hecktor_raw, str(tmp_path / tag), **SMALL_GEOMETRY)
        cfgs[tag] = _write(tmp_path / f"{tag}.yaml", cfg)
    prepare_hecktor21.main(["--config", cfgs["w1"]], device="cpu")
    prepare_hecktor21.main(["--config", cfgs["w2"], "--workers", "2"], device="cpu")
    m1, m2 = (_frame(tmp_path / t / "manifest.csv", tmp_path / t) for t in ("w1", "w2"))
    pd.testing.assert_frame_equal(m1, m2)
    assert "missing_file" in set(m1["status"]) and "error:ValueError" in set(m1["status"])
    for p in pd.read_csv(tmp_path / "w1" / "manifest.csv").dropna(subset=["ct_proc"])[["ct_proc", "pt_proc",
                                                                                          "gtvt_proc"]].values.ravel():
        np.testing.assert_array_equal(np.asarray(nifti.load(p).dataobj),
                                      np.asarray(nifti.load(p.replace(str(tmp_path / "w1"),
                                                                      str(tmp_path / "w2"))).dataobj))


def test_brats_cli_matches_reference_and_pool(tmp_path, monkeypatch, jax_scripts):
    raw = chip_smoke.write_raw_brats(str(tmp_path / "raw"), shape=(30, 34, 28), cases=3)
    base = {"raw_root": raw, "target_spacing": [1.2, 1.0, 1.0], "output_size": [24, 28, 24], "split_seed": 1,
            "split_ratios": [0.5, 0.25, 0.25]}
    paths = {tag: _write(tmp_path / f"{tag}.yaml", {**base, "out_root": str(tmp_path / tag)})
             for tag in ("port", "jax", "port_w2")}
    res = prepare_brats.main(["--config", paths["port"]], device="cpu")
    prepare_brats.main(["--config", paths["port_w2"], "--workers", "2"], device="cpu")
    _run_jax(jax_scripts[1], monkeypatch, "--config", paths["jax"])
    got = _frame(tmp_path / "port" / "processed.csv", tmp_path / "port")
    pd.testing.assert_frame_equal(got, _frame(tmp_path / "jax" / "processed.csv", tmp_path / "jax"))
    pd.testing.assert_frame_equal(got, _frame(tmp_path / "port_w2" / "processed.csv", tmp_path / "port_w2"))
    assert len(got) == 12 and (got["status"] == "ok").all() and len(set(got["split"])) > 1
    assert sorted(res["part_ms"]) == sorted(set(got["subject_id"]))
    mf = pd.read_csv(tmp_path / "port" / "processed.csv")
    for col, label in (("img_path", False), ("label_path", True)):
        for p in sorted(set(mf[col])):
            _assert_volumes(p, p.replace(str(tmp_path / "port"), str(tmp_path / "jax")), label)
            w2 = p.replace(str(tmp_path / "port"), str(tmp_path / "port_w2"))
            np.testing.assert_array_equal(np.asarray(nifti.load(p).dataobj), np.asarray(nifti.load(w2).dataobj))
    seg = np.asarray(nifti.load(mf["label_path"][0]).dataobj)
    assert seg.shape == (24, 28, 24) and set(np.unique(seg)) <= {0, 1, 2, 3}


def test_brats_error_rows(tmp_path):
    raw = chip_smoke.write_raw_brats(str(tmp_path / "raw"), shape=(20, 22, 18), cases=2)
    case = sorted(os.listdir(raw))[1]
    os.remove(os.path.join(raw, case, f"{case}-t2w.nii.gz"))
    cfg = _write(tmp_path / "b.yaml", {"raw_root": raw, "out_root": str(tmp_path / "out"),
                                       "output_size": [16, 16, 16], "split_ratios": [1.0, 0.0, 0.0]})
    rows = prepare_brats.main(["--config", cfg], device="cpu")["rows"]
    assert [r["status"] for r in rows] == ["ok"] * 4 + ["error:FileNotFoundError"]


def test_chip_smoke_preprocess_phase_runs_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 21 at fixture size on the CPU: raw NIfTI ->
    ``cli.prepare_hecktor21`` -> ``cli.train`` -> ``cli.adapt`` with Tent,
    BraTS, the unused ops; every check it makes that holds on any device (the
    kernel launch counts are the card's)."""
    small = ["dataset.expected_shape=[16,16,16]", "training.data.transforms.image_size=[16,16,16]",
             "model.channels=[2,4,8,16,32]", "model.num_res_units=1", "training.compute_dtype=float32",
             "training.num_workers=2"]
    ops_kw = dict(image2d=(1, 192, 192, 1), rot_batch=(4, 4, 8, 8, 2), seg_batch=(2, 4, 8, 8, 1), embed=(8, 16, 3),
                  mog=dict(latent_size=16, channels=(4, 8, 16, 32), strides=(2, 2), image_size=(32, 32), mog_k=4,
                           use_gate=True), mog_batch=2)
    out = chip_smoke.preprocess_phase("cpu", str(tmp_path / "p21"), **SMALL, **SMALL_GEOMETRY,
                                      brats_shape=(30, 34, 28), brats_output=(24, 28, 24), extra=small,
                                      ops_kw=ops_kw)
    h = out["hecktor"]
    assert h["cases"] == 6 and h["ct_resampled"] == "39,39,12" and h["splits"].count("test") == 2
    assert h["cpu_case"]["row_equal"] and all(v["equal"] for v in h["cpu_case"]["volumes"].values())
    assert out["brats"]["cases"] == 2 and all(v["equal"] for v in out["brats"]["volumes"].values())
    assert out["train"]["steps"] == 1 and out["train"]["val_batches"] == 1 and out["adapt"]["test_batches"] == 1
    assert out["train"]["want"] == {"forward": 36, "backward": 18, "minplus": 1}
    assert len(out["edt"]) == 3 and all(e["bitwise_plain"] for e in out["edt"])
    assert out["ops"]["rand_rot90"]["k"] == [0, 1, 2, 3]
    assert not os.path.exists(tmp_path / "p21")
