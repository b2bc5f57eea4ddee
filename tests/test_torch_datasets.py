"""The port's dataset plumbing against the JAX package's: the synthetic
fixtures (data/synthetic.py), the manifest reading that stands in for pandas
(data/csv_table.py), the HECKTOR21 and BraTS builders (data/hecktor21.py,
data/brats.py) and the device-resident training cache (data/device_cache.py).

Everything here is compared bitwise: the same seed writes the same volumes
and manifest rows; the builders give the same case ids per split, the same
domains, equal samples and equal loader batches; the device cache on the CPU
gives the host loader's batches after its f16 / uint8 transfer."""

import csv
import math
import os

import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_tta_tpu.conf import compose as jax_compose
from multimodal_tta_tpu.data import brats as jax_brats
from multimodal_tta_tpu.data import hecktor21 as jax_hecktor21
from multimodal_tta_tpu.data import nifti as jax_nifti
from multimodal_tta_tpu.data import synthetic as jax_synthetic
from multimodal_tta_tpu_torch.conf import ConfigNode, compose
from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
from multimodal_tta_tpu_torch.data import brats, csv_table, hecktor21, synthetic
from multimodal_tta_tpu_torch.data.device_cache import DeviceCachedLoader
from multimodal_tta_tpu_torch.data.loader import HostLoader
from multimodal_tta_tpu_torch.data.prefetch import prefetch_to_device
from multimodal_tta_tpu_torch.data.transforms import get_seg_transforms
from multimodal_tta_tpu_torch.registry import get_dataset_builder, list_dataset_builders, list_datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "configs")
SHAPE = (16, 16, 16)
CENTERS = {"CHUS": 3, "CHUM": 4, "CHGJ": 4}


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _csv_text(path, root):
    with open(path, encoding="utf-8") as f:
        return f.read().replace(str(root), "<root>")


@pytest.fixture(scope="module")
def hecktor(tmp_path_factory):
    """The same HECKTOR21 fixture written by both packages."""
    root = tmp_path_factory.mktemp("hecktor")
    port = synthetic.make_hecktor_fixture(str(root / "port"), shape=SHAPE, centers=CENTERS, seed=3)
    ref = jax_synthetic.make_hecktor_fixture(str(root / "jax"), shape=SHAPE, centers=CENTERS, seed=3)
    return {"port": port, "jax": ref, "root": root}


@pytest.fixture(scope="module")
def brats_csvs(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats")
    sources = {"glipre": {"profile": "gli", "cases": {"train": 4, "test": 2}},
               "ssa": {"profile": "ssa", "cases": {"train": 2}},
               "ped": {"profile": "ped", "cases": {"train": 2}}}
    port = synthetic.make_brats_fixture(str(root / "port"), shape=SHAPE, sources=sources)
    ref = jax_synthetic.make_brats_fixture(str(root / "jax"), shape=SHAPE, sources=sources)
    return {"port": port, "jax": ref, "root": root}


def test_hecktor_fixtures_are_equal(hecktor):
    root = hecktor["root"]
    port, ref = _files(root / "port"), _files(root / "jax")
    assert port.keys() == ref.keys() and len(port) == 3 * sum(CENTERS.values()) + 1
    for name in port:
        if name != "manifest.csv":
            assert port[name] == ref[name], name  # same bytes: same volumes, same headers
    assert (_csv_text(hecktor["port"], root / "port") == _csv_text(hecktor["jax"], root / "jax"))


@pytest.mark.parametrize("kw", [
    dict(n_lesions=(1, 3), radius_range=(2.0, 4.0)),
    dict(domain_shift={"CHUS": {"ct_gain": 1.3, "ct_bias": 40.0, "pt_gamma": 0.7, "pt_gain": 1.2,
                                "noise": 20.0, "bias_field": 0.3}}),
], ids=["lesions", "domain_shift"])
def test_hecktor_fixture_options_are_equal(tmp_path, kw):
    centers = {"CHUS": 2, "CHUM": 1}
    p = synthetic.make_hecktor_fixture(str(tmp_path / "p"), shape=(12, 10, 8), centers=centers, seed=5, **kw)
    j = jax_synthetic.make_hecktor_fixture(str(tmp_path / "j"), shape=(12, 10, 8), centers=centers, seed=5, **kw)
    assert _files(tmp_path / "p") == {k: v.replace(str(tmp_path / "j").encode(), str(tmp_path / "p").encode())
                                      for k, v in _files(tmp_path / "j").items()}
    assert _csv_text(p, tmp_path / "p") == _csv_text(j, tmp_path / "j")


@pytest.mark.parametrize("n_lesions", [None, (1, 2)], ids=["uniform", "structured"])
def test_brats_fixtures_are_equal(tmp_path, n_lesions):
    sources = {"gli": {"profile": "gli", "cases": {"train": 2, "test": 1}},
               "ped": {"profile": "ped", "cases": {"train": 1, "val": 1}}}
    p = synthetic.make_brats_fixture(str(tmp_path / "p"), sources=sources, n_lesions=n_lesions)
    j = jax_synthetic.make_brats_fixture(str(tmp_path / "j"), sources=sources, n_lesions=n_lesions)
    assert p.keys() == j.keys()
    pf, jf = _files(tmp_path / "p"), _files(tmp_path / "j")
    assert pf.keys() == jf.keys()
    for name in pf:
        if name.endswith(".csv"):
            assert pf[name].decode().replace(str(tmp_path / "p"), "<r>") == \
                jf[name].decode().replace(str(tmp_path / "j"), "<r>")
        else:
            assert pf[name] == jf[name], name


# ---------------------------------------------------------------------------
# the manifest as pandas reads it
# ---------------------------------------------------------------------------
QUIRKS = [
    ["patient_id", "center_code", "center_id", "status", "ct_proc", "pt_proc", "gtvt_proc", "split", "score"],
    ["a0", "chus", "0", "ok", "a0_ct.nii.gz", "a0_pt.nii.gz", "a0_gt.nii.gz", "train", "1"],
    ["a1", "CHUS", "0", "OK", "a1_ct.nii.gz", "a1_pt.nii.gz", "", "train", ""],
    ["b0", "Chum", "1", "ok", "b0_ct.nii.gz", "b0_pt.nii.gz", "b0_gt.nii.gz", "", "2.5"],
    ["b1", "CHUM", "1", "failed", "b1_ct.nii.gz", "b1_pt.nii.gz", "b1_gt.nii.gz", "train", "3"],
    ["b2", "chum", "1", "ok", "b2_ct.nii.gz", "b2_pt.nii.gz", "NA", "train", "4"],
    ["b3", "CHUM", "1", "ok", "b3_ct.nii.gz", "b3_pt.nii.gz", "b3_gt.nii.gz", "train", "5"],
    ["c0", "CHGJ", "2", "ok", "c0_ct.nii.gz", "c0_pt.nii.gz", "c0_gt.nii.gz", "train", "6"],
    ["c1", "chgj", "2", "", "c1_ct.nii.gz", "c1_pt.nii.gz", "c1_gt.nii.gz", "train", "7"],
    ["c2", "CHGJ", "2", "ok", "c2_ct.nii.gz", "c2_pt.nii.gz", "c2_gt.nii.gz", "train", "nan"],
    ["c3", "CHGJ", "2", "ok", "c3_ct.nii.gz", "c3_pt.nii.gz", "c3_gt.nii.gz", "train", "8"],
    ["d0", "107", "3", "ok", "d0_ct.nii.gz", "d0_pt.nii.gz", "d0_gt.nii.gz", "train", "9"],
    ["d1", "107", "3", "ok", "d1_ct.nii.gz", "d1_pt.nii.gz", "d1_gt.nii.gz", "train", "10"],
]


def _write(path, rows):
    with open(path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f, lineterminator="\n").writerows(rows)
    return str(path)


def _norm(v):
    """A cell as a comparable value: NaN as a marker, numpy scalars as Python."""
    if isinstance(v, (float, np.floating)) and math.isnan(v):
        return "<nan>"
    if isinstance(v, np.generic):
        v = v.item()
    return (type(v).__name__ if not isinstance(v, bool) else "bool", v)


def _records(df):
    return [{k: _norm(v) for k, v in r.items()} for r in df.to_dict(orient="records")]


def test_read_csv_types_cells_as_pandas_does(tmp_path):
    path = _write(tmp_path / "m.csv", QUIRKS + [["e0", "CHUS", "4", "True", "x", "y", "z", "test", "1e3"]])
    table = csv_table.read_csv(path)
    df = pd.read_csv(path)
    assert table.columns == list(df.columns)
    assert table.index == df.index.tolist()
    assert [{k: _norm(v) for k, v in r.items()} for r in table.rows] == _records(df)
    for col in df.columns:
        assert [csv_table.notna(r[col]) for r in table.rows] == df[col].notna().tolist()
        # astype(str) of a filled cell (pandas 3 keeps an empty one NaN, pandas 2
        # writes 'nan': either way no ok-status or center code matches it)
        filled = df[col].notna().tolist()
        assert [str(r[col]) for r, f in zip(table.rows, filled) if f] == \
            [v for v, f in zip(df[col].astype(str).tolist(), filled) if f]


@pytest.mark.parametrize("target,val_per_center,seed", [("CHUS", 1, 2026), ("chum", 2, 7), ("CHGJ", 5, 0),
                                                        ("107", 1, 3), ("CHUS", 0, 1)])
@pytest.mark.parametrize("drop_unlabeled", [True, False])
def test_center_splits_match_pandas(tmp_path, target, val_per_center, seed, drop_unlabeled):
    path = _write(tmp_path / "m.csv", QUIRKS)
    kw = dict(target_center=target, val_per_center=val_per_center, split_seed=seed,
              drop_unlabeled=drop_unlabeled, required_cols=("patient_id", "ct_proc", "pt_proc", "center_code"),
              label_col="gtvt_proc", status_col="status", ok_status_values=["ok"], center_code_col="center_code")
    got, n_got = hecktor21.build_center_splits(path, **kw)
    want, n_want = jax_hecktor21.build_center_splits(path, **kw)
    assert n_got == n_want
    for split in ("train", "val", "test"):
        assert got[split].index == want[split].index.tolist(), split
        assert [{k: _norm(v) for k, v in r.items()} for r in got[split].rows] == _records(want[split])


def test_val_draw_matches_pandas(tmp_path):
    rng = np.random.RandomState(0)
    codes = ["CHUS", "chum", "CHGJ", "CHMR", "101"]
    rows = [["patient_id", "center_code"]] + [[f"p{i}", codes[rng.randint(5)]] for i in range(40)]
    path = _write(tmp_path / "v.csv", rows)
    table, df = csv_table.read_csv(path), pd.read_csv(path)
    keep = [i % 3 != 0 for i in range(40)]  # row labels with gaps, as after a filter
    table, df = table.take(keep), df[keep]
    for seed in (2026, 7, 123):
        for k in (1, 3, 20):
            got = hecktor21.sample_val_indices_per_center(table, "center_code", k, seed)
            want = jax_hecktor21.sample_val_indices_per_center(df, "center_code", k, seed)
            assert got.dtype == np.int64 and np.array_equal(got, want)


def test_brats_csv_grouping_matches_pandas(tmp_path):
    rows = [["subject_id", "modality", "img_path", "label_path", "split"]]
    for sid, split in (("s2", "train"), ("s1", "test"), ("s3", "Train ")):
        for m in ("t1n", "t1c", "t2w", "t2f"):
            rows.append([sid, m.upper() if sid == "s3" else m, f"{sid}_{m}.nii.gz",
                         f"{sid}_seg.nii.gz" if m == "t1c" or sid == "s2" else "", split])
    rows.append(["", "t1n", "orphan.nii.gz", "orphan_seg.nii.gz", "train"])  # no subject: dropped
    rows.append(["s1", "t1n", "s1_t1n_v2.nii.gz", "", "val"])  # the last row per modality wins
    rows.append(["s4", "t1n", "s4_t1n.nii.gz", "s4_seg.nii.gz", "train"])  # modalities missing
    path = _write(tmp_path / "p.csv", rows)
    for drop_unlabeled in (True, False):
        kw = dict(root_dir=str(tmp_path), drop_unlabeled=drop_unlabeled)
        got = brats.parse_processed_csv_to_cases(path, ["t1n", "t1c", "t2w", "t2f"], **kw)
        want = jax_brats.parse_processed_csv_to_cases(path, ["t1n", "t1c", "t2w", "t2f"], **kw)
        assert list(got) == list(want) and got == want


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------
def _hecktor_overrides(manifest):
    return ["task=hecktor21", "dataset=hecktor21", "hydra.run.dir=/tmp/unused", f"dataset.manifest_csv={manifest}",
            f"dataset.expected_shape={list(SHAPE)}", "dataset.val_per_center=1", "training.batch_size=2",
            "training.eval_batch_size=3", "training.num_workers=0",
            f"training.data.transforms.image_size={list(SHAPE)}"]


def _same_sample(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes(), k
        else:
            assert _norm(a[k]) == _norm(b[k]) if not isinstance(a[k], list) else a[k] == b[k], k


def _same_batches(port_loader, jax_loader, epochs=2):
    n = 0
    for _ in range(epochs):
        for a, b in zip(port_loader, jax_loader, strict=True):
            _same_sample(a, b)
            n += 1
    return n


@pytest.mark.parametrize("extra", [[], ["dataset.target_center=CHUM", "dataset.split_seed=11",
                                        "dataset.cache_in_memory=true"]], ids=["stock", "chum"])
def test_hecktor_builder_matches_reference(hecktor, extra):
    port_cfg = compose(CONFIG_DIR, "config", _hecktor_overrides(hecktor["jax"]) + extra)
    jax_cfg = jax_compose(CONFIG_DIR, "config", _hecktor_overrides(hecktor["jax"]) + extra)
    assert port_cfg.to_container() == jax_cfg.to_container()
    ours, theirs = hecktor21.Hecktor21Builder(port_cfg), jax_hecktor21.Hecktor21Builder(jax_cfg)
    sizes = {}
    for split in ("train", "val", "test"):
        a, b = ours.get_dataset(split), theirs.get_dataset(split)
        assert [r["patient_id"] for r in a._rows] == [r["patient_id"] for r in b._rows]
        sizes[split] = len(a)
        for i in range(len(a)):
            _same_sample(a[i], b[i])
            got_aff, got_shape = a.source_geometry(i)
            want_aff, want_shape = b.source_geometry(i)
            np.testing.assert_array_equal(got_aff, want_aff)
            assert got_shape == want_shape
        assert _same_batches(ours.get_loader(split, dataset=a), theirs.get_loader(split, dataset=b)) > 0
        dev = ours.build_transform(split).device_spec()
        assert dev == theirs.build_transform(split).device_spec()
    target = port_cfg.dataset.target_center
    assert sizes["test"] == CENTERS[target] and sizes["val"] == 2
    assert sizes["train"] == sum(CENTERS.values()) - CENTERS[target] - 2


def _brats_overrides(csvs):
    return ["task=brats", "dataset=brats", "hydra.run.dir=/tmp/unused",
            f"dataset.sources.0.csv_path={csvs['glipre']}", f"dataset.sources.1.csv_path={csvs['ssa']}",
            f"dataset.sources.2.csv_path={csvs['ped']}", f"dataset.expected_shape={list(SHAPE)}",
            "training.batch_size=2", "training.eval_batch_size=2", "training.num_workers=2",
            f"training.data.transforms.image_size={list(SHAPE)}"]


def test_brats_builder_matches_reference(brats_csvs):
    port_cfg = compose(CONFIG_DIR, "config", _brats_overrides(brats_csvs["jax"]))
    jax_cfg = jax_compose(CONFIG_DIR, "config", _brats_overrides(brats_csvs["jax"]))
    assert port_cfg.to_container() == jax_cfg.to_container()
    ours, theirs = brats.BratsMultiNiftiBuilder(port_cfg), jax_brats.BratsMultiNiftiBuilder(jax_cfg)
    for split, n in (("train", 4), ("val", 2), ("test", 4)):
        a, b = ours.get_dataset(split), theirs.get_dataset(split)
        assert len(a) == len(b) == n
        samples = [(a[i], b[i]) for i in range(n)]
        for x, y in samples:
            _same_sample(x, y)
        if split == "test":
            assert sorted({x["domain"] for x, _ in samples}) == ["brats24_ped", "brats24_ssa"]
        assert _same_batches(ours.get_loader(split, dataset=a), theirs.get_loader(split, dataset=b)) > 0
    assert brats.DEFAULT_REGION_MAPS == jax_brats.DEFAULT_REGION_MAPS
    raw = np.random.RandomState(0).randint(0, 5, size=(4, 5, 6)).astype(np.float32)
    for profile, region_map in brats.DEFAULT_REGION_MAPS.items():
        got = brats.build_region_masks_from_raw(raw, region_map)
        want = jax_brats.build_region_masks_from_raw(raw, region_map)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), profile


def test_registry_lists_the_builders():
    assert {"hecktor21", "brats"} <= set(list_dataset_builders())
    assert get_dataset_builder("hecktor21") is hecktor21.Hecktor21Builder
    assert get_dataset_builder("brats") is brats.BratsMultiNiftiBuilder
    assert isinstance(list_datasets(), list)


# ---------------------------------------------------------------------------
# device cache
# ---------------------------------------------------------------------------
def _train_dataset(manifest, transform=None):
    return hecktor21.Hecktor21Dataset(manifest, "train", target_center="CHUS", val_per_center=1,
                                      expected_shape=SHAPE, transform=transform)


@pytest.mark.parametrize("shuffle,drop_last,batch", [(True, False, 3), (True, True, 2), (False, False, 4)])
def test_device_cache_on_cpu_equals_host_loader(hecktor, shuffle, drop_last, batch):
    ds = _train_dataset(hecktor["port"])
    cache = DeviceCachedLoader(ds, batch_size=batch, shuffle=shuffle, drop_last=drop_last, seed=9,
                               device="cpu", num_workers=2)
    host = HostLoader(ds, batch_size=batch, shuffle=shuffle, drop_last=drop_last, seed=9, num_workers=2)
    assert len(cache) == len(host) and cache.device_resident
    assert cache.store_bytes == len(ds) * (int(np.prod(SHAPE)) * 2 * 2 + int(np.prod(SHAPE)))
    n = 0
    for epoch in range(3):
        stream = prefetch_to_device(host, "cpu", image_transfer_dtype=torch.float16,
                                    label_transfer_dtype=torch.uint8)
        for got, want in zip(cache, stream, strict=True):
            assert got["image"].dtype == torch.float16 and got["label"].dtype == torch.uint8
            assert torch.equal(got["image"], want["image"]) and torch.equal(got["label"], want["label"])
            assert got["_n_valid"] == want["_n_valid"]
            n += 1
    assert n == 3 * len(host)
    cache.set_epoch(1)
    host.set_epoch(1)
    first = next(iter(cache))
    want = next(iter(prefetch_to_device(host, "cpu", image_transfer_dtype=torch.float16)))
    assert torch.equal(first["image"], want["image"])


def test_device_cache_rejects_what_it_cannot_hold(hecktor):
    ds = _train_dataset(hecktor["port"], transform=get_seg_transforms(ndim=3, split="train", geom_aug=True))
    with pytest.raises(ValueError, match="host-side geometric augmentation"):
        DeviceCachedLoader(ds, batch_size=2, device="cpu")
    ds = _train_dataset(hecktor["port"])
    # on one rank the sharded store is the replicated one, as in the reference
    assert not DeviceCachedLoader(ds, batch_size=2, device="cpu", shard_store=True).shard_store
    with pytest.raises(ValueError, match="exceeds the dataset"):
        DeviceCachedLoader(ds, batch_size=100, drop_last=True, device="cpu")
    with pytest.raises(TypeError, match="image_dtype"):  # the store's dtypes are the host loader's
        DeviceCachedLoader(ds, batch_size=2, device="cpu", image_dtype=np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceCachedLoader(ds, batch_size=2)


@pytest.mark.parametrize("device_cache", [False, True])
def test_manager_sets_up_data_through_the_builder(hecktor, device_cache):
    cfg = compose(CONFIG_DIR, "config", _hecktor_overrides(hecktor["port"]) + [
        f"training.device_cache={str(device_cache).lower()}"])
    m = ExperimentManager(cfg, device="cpu")
    train, val, test = m.setup_data("train")
    assert isinstance(train, DeviceCachedLoader) == device_cache
    assert len(train.dataset) == 6 and len(val.dataset) == 2 and len(test.dataset) == 3
    assert isinstance(m._builder, hecktor21.Hecktor21Builder)
    test_only, none = m.setup_data("test")
    assert none is None and len(test_only.dataset) == 3
    assert len(m.build_clean_dataset("val")) == 2
    with pytest.raises(ValueError, match="Unknown mode"):
        m.setup_data("predict")
    sharded = ConfigNode(cfg.to_container())
    sharded.set_path("training.device_cache", True)
    sharded.set_path("training.device_cache_sharded", True)
    assert not ExperimentManager(sharded, device="cpu").setup_data("train")[0].shard_store  # one rank
