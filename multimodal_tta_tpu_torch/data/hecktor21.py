"""HECKTOR21 PET/CT dataset with dynamic leave-one-center-out splits (the
port of ``multimodal_tta_tpu/data/hecktor21.py``).

The manifest is read by ``data/csv_table.py`` instead of pandas, with the
pandas semantics the splits depend on matched by hand: type inference
(a numeric ``center_id`` column holds ints), empty cells as NaN, ``astype(str)``
of center codes and the row labels the seeded validation draw picks from.

Split semantics are bit-exact with the reference (reference:
src/datasets/hecktor21.py:66-89, 159-232): given target_center T, test = all
rows with center T; the remaining rows are split train/val by drawing
``val_per_center`` row indices per center with one shared
``np.random.RandomState(split_seed)`` iterating centers in sorted order — the
exact same RNG consumption order, so splits (and thus Dice) match the CPU
reference for identical manifests.

Sample layout (TPU-native channels-last):
  image: float32 [D, H, W, 2]  (D=Z, H=Y, W=X; channels CT, PET)
  label: float32 [D, H, W, 1]  (binary GTVt)
  domain = center_code
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..conf.node import ConfigNode
from ..registry import register_dataset_builder
from ..utils.config import get_config, require_config
from ..utils.logger import get_logger
from .base_builder import BaseDatasetBuilder
from .csv_table import Table, notna, read_csv
from .manifest import resolve_manifest_path
from .nifti import DecodedCache, DiskDecodedCache, load_canonical_dhw
from .transforms import get_seg_transforms


def _validate_shape(arr: np.ndarray, expected: Optional[Tuple[int, ...]], what: str, case_id: str) -> None:
    """Volumes arrive pre-unified by the offline preprocessing stage; any
    other shape here means the manifest points at the wrong tree."""
    if expected is not None and tuple(arr.shape) != tuple(expected):
        raise ValueError(
            f"[HECKTOR21] Shape mismatch: {what} of case '{case_id}' is "
            f"{tuple(arr.shape)} but the configured expected_shape is "
            f"{tuple(expected)} — check dataset.expected_shape vs the "
            f"preprocessing output_size."
        )


def to_binary_mask(y: np.ndarray) -> np.ndarray:
    """Normalize a stored GTVt mask to uint8 {0,1}.

    HECKTOR exports occur in three encodings — {0,1}, {0,255}, and general
    nonzero-means-foreground — all of which must land on {0,1} (behavioral
    contract pinned by tests/test_datasets.py::TestBinaryMask; reference
    semantics: src/datasets/hecktor21.py:51-63).
    """
    arr = np.asarray(y)
    if arr.dtype.kind not in "iu":  # floats (and bools) get rounded first
        arr = np.rint(arr)
    arr = arr.astype(np.int16, copy=False)
    values = set(np.unique(arr).tolist())
    if values <= {0, 1}:
        return arr.astype(np.uint8, copy=False)
    return (arr != 0).astype(np.uint8)  # covers {0,255} and mixed encodings


def sample_val_indices_per_center(
    table: Table,
    center_code_col: str,
    val_per_center: int,
    seed: int,
) -> np.ndarray:
    """Draw the per-center validation rows.

    RNG-consumption-compatible with the CPU reference so splits are
    bit-identical for identical manifests (SURVEY.md §7.3 hard-part 6):
    one shared ``np.random.RandomState(seed)`` visits the non-target centers
    in sorted (uppercased) order and draws ``min(val_per_center, n_center)``
    row labels without replacement from each. Returns the chosen row labels
    as int64.
    """
    if val_per_center <= 0 or not len(table):
        return np.array([], dtype=np.int64)

    codes = [str(r[center_code_col]).upper() for r in table.rows]
    labels = np.asarray(table.index, dtype=np.int64)
    rng = np.random.RandomState(seed)
    picks: List[np.ndarray] = []
    for code in sorted(set(codes)):
        rows = labels[np.asarray([c == code for c in codes])]
        if rows.size:
            picks.append(rng.choice(rows, size=min(int(val_per_center), int(rows.size)), replace=False))
    if not picks:
        return np.array([], dtype=np.int64)
    return np.concatenate(picks).astype(np.int64)


def build_center_splits(
    manifest_csv: str,
    *,
    target_center: str,
    val_per_center: int,
    split_seed: int,
    drop_unlabeled: bool,
    required_cols: Sequence[str],
    label_col: str,
    status_col: str,
    ok_status_values: Sequence[str],
    center_code_col: str,
) -> Tuple[Dict[str, Table], int]:
    """Leave-one-center-out partition of the manifest.

    The domain-shift protocol (reference behavior: src/datasets/hecktor21.py
    159-232, SURVEY.md §0.4): the held-out ``target_center`` becomes the
    entire test split; every other center contributes training rows except a
    seeded per-center validation draw. Row filtering happens BEFORE the
    split in a fixed order — preprocessing status, then label presence —
    because the validation draw consumes RNG per surviving row set and must
    stay bit-identical to the CPU reference for the same manifest.

    Returns ({"train","val","test"} -> Table, number of source centers).
    """
    if not os.path.exists(manifest_csv):
        raise FileNotFoundError(f"[HECKTOR21] manifest_csv not found: {manifest_csv}")
    df = read_csv(manifest_csv)

    missing = [c for c in required_cols if c not in df.columns]
    if missing:
        raise ValueError(f"[HECKTOR21] manifest lacks required column(s): {missing}")
    if label_col not in df.columns:
        df.add_column(label_col, np.nan)
    if status_col not in df.columns:
        df.add_column(status_col, "ok")

    # keep only rows whose offline preprocessing succeeded
    ok_values = {str(v).lower() for v in ok_status_values}
    df = df.take([str(r[status_col]).lower() in ok_values for r in df.rows])
    if drop_unlabeled:
        df = df.take([notna(r[label_col]) and str(r[label_col]) != "" for r in df.rows])

    for r in df.rows:
        r[center_code_col] = str(r[center_code_col]).upper()
    # multi-target: a comma-separated string (or list) holds several centers
    # out at once — the streaming continual-TTA protocol (BASELINE config
    # #5) needs an ordered multi-domain test stream; single-center behavior
    # (the reference's leave-one-center-out) is unchanged.
    raw = (
        target_center.split(",")
        if isinstance(target_center, str)
        else list(target_center)
    )
    targets = {str(t).upper().strip() for t in raw if str(t).strip()}
    if not targets:
        raise ValueError("[HECKTOR21] target_center cannot be empty")

    is_target = [r[center_code_col] in targets for r in df.rows]
    test_df = df.take(is_target)
    source_df = df.take([not t for t in is_target])
    if not len(test_df):
        raise ValueError(
            f"[HECKTOR21] no usable rows for target_center(s) {sorted(targets)} — "
            f"available centers: {sorted({r[center_code_col] for r in df.rows})}"
        )
    if not len(source_df):
        raise ValueError(
            f"[HECKTOR21] every row belongs to target_center(s) {sorted(targets)}; "
            f"nothing left to train on."
        )

    val_rows = sample_val_indices_per_center(
        source_df, center_code_col, val_per_center, split_seed
    )
    position = {label: i for i, label in enumerate(source_df.index)}
    val_df = Table(list(source_df.columns), [dict(source_df.rows[position[int(v)]]) for v in val_rows],
                   [int(v) for v in val_rows])
    picked = set(int(v) for v in val_rows)
    train_df = source_df.take([label not in picked for label in source_df.index])

    splits = {"train": train_df, "val": val_df, "test": test_df}
    return splits, len({r[center_code_col] for r in source_df.rows})


@dataclass(frozen=True)
class ManifestSchema:
    """Which manifest columns carry what. One object instead of eight
    constructor knobs; override any field via dataset.* config keys."""

    patient: str = "patient_id"
    status: str = "status"
    ok_status_values: Tuple[str, ...] = ("ok",)
    ct: str = "ct_proc"
    pt: str = "pt_proc"
    label: str = "gtvt_proc"
    center_code: str = "center_code"
    center_id: str = "center_id"


class Hecktor21Dataset:
    def __init__(
        self,
        manifest_csv: str,
        split: str,
        *,
        target_center: str,
        val_per_center: int = 5,
        split_seed: int = 2026,
        expected_shape: Optional[Tuple[int, int, int]] = None,  # (X,Y,Z)
        drop_unlabeled: bool = True,
        strict_label_values: bool = True,
        root_dir: Optional[str] = None,
        schema: Optional[ManifestSchema] = None,
        transform: Optional[Callable] = None,
        cache_in_memory: bool = False,
        decode_cache_dir: Optional[str] = None,
        logger=None,
    ):
        self.logger = logger or get_logger()
        self.split = str(split).lower().strip()
        if self.split not in ("train", "val", "test"):
            raise ValueError(f"[HECKTOR21] split must be in {{train,val,test}}, got '{split}'")

        self.expected_shape = tuple(expected_shape) if expected_shape is not None else None
        self.drop_unlabeled = bool(drop_unlabeled)
        self.strict_label_values = bool(strict_label_values)
        self.root_dir = root_dir
        self.transform = transform
        self._cache = (
            DecodedCache()
            if cache_in_memory
            else (DiskDecodedCache(decode_cache_dir) if decode_cache_dir else None)
        )
        self._epoch = 0
        self.schema = sc = schema or ManifestSchema()

        splits, n_other_centers = build_center_splits(
            manifest_csv,
            target_center=target_center,
            val_per_center=int(val_per_center),
            split_seed=int(split_seed),
            drop_unlabeled=self.drop_unlabeled,
            required_cols=(sc.patient, sc.ct, sc.pt, sc.center_code),
            label_col=sc.label,
            status_col=sc.status,
            ok_status_values=[str(x).lower() for x in sc.ok_status_values],
            center_code_col=sc.center_code,
        )
        chosen = splits[self.split]
        if not len(chosen):
            raise ValueError(
                f"[HECKTOR21] No rows land in split '{self.split}' "
                f"(target_center={target_center}, val_per_center={val_per_center})."
            )

        self._rows: List[Dict[str, Any]] = chosen.rows
        self.logger.info(
            f"[HECKTOR21] {self.split}: {len(self._rows)} cases "
            f"(target={str(target_center).upper().strip()}, "
            f"{n_other_centers} source centers, "
            f"val_per_center={val_per_center}, split_seed={split_seed})"
        )

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return len(self._rows)

    def source_geometry(self, idx: int):
        """(canonical RAS+ affine, (X,Y,Z) shape) of the case's CT grid —
        the geometry predictions must be written back into. Header-only."""
        from .nifti import peek_canonical_geometry

        sc = self.schema
        info = self._rows[idx]
        case_id = str(info.get(sc.patient))
        ct_path = self._file_of(info, sc.ct, "CT", case_id)
        return peek_canonical_geometry(ct_path)

    # -- per-sample assembly -------------------------------------------------

    def _file_of(self, info: Dict[str, Any], column: str, kind: str, case_id: str,
                 required: bool = True) -> str:
        p = resolve_manifest_path(info.get(column, ""), self.root_dir)
        if required and not (p and os.path.exists(p)):
            raise FileNotFoundError(
                f"[HECKTOR21] {kind} volume missing on disk for case '{case_id}': {p!r}"
            )
        return p

    def _decode(self, path: str) -> np.ndarray:
        # fused native decode straight to (D,H,W)=(Z,Y,X)
        if self._cache is not None:
            return self._cache.get_or_load(path)
        return load_canonical_dhw(path)

    def _load_label(self, lb_path: str, like: np.ndarray, exp_dhw, case_id: str) -> np.ndarray:
        if not (lb_path and os.path.exists(lb_path)):
            return np.zeros(like.shape, dtype=np.uint8)  # unlabeled target case
        raw = self._decode(lb_path)
        _validate_shape(raw, exp_dhw, "label", case_id)
        return to_binary_mask(raw)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        sc = self.schema
        info = self._rows[idx]
        case_id = str(info.get(sc.patient))
        center_code = str(info.get(sc.center_code, "")).upper()
        try:
            raw_cid = info.get(sc.center_id, None)
            center_id = int(raw_cid) if (raw_cid is not None and str(raw_cid) != "nan") else -1
        except Exception:
            center_id = -1

        ct_path = self._file_of(info, sc.ct, "CT", case_id)
        pt_path = self._file_of(info, sc.pt, "PET", case_id)
        lb_path = self._file_of(info, sc.label, "label", case_id, required=self.drop_unlabeled)

        exp_dhw = self.expected_shape[::-1] if self.expected_shape else None
        ct = self._decode(ct_path)
        pt = self._decode(pt_path)
        _validate_shape(ct, exp_dhw, "ct", case_id)
        _validate_shape(pt, exp_dhw, "pt", case_id)
        image = np.stack([ct, pt], axis=-1)  # [D,H,W,2]

        mask = self._load_label(lb_path, ct, exp_dhw, case_id)
        label = mask[..., None].astype(np.float32)  # [D,H,W,1]
        if self.strict_label_values:
            observed = set(np.unique(label).tolist())
            if not observed <= {0.0, 1.0}:
                raise ValueError(
                    f"[HECKTOR21] case '{case_id}': mask values {sorted(observed)} "
                    f"are not binary after coercion"
                )

        if self.transform is not None:
            rng = np.random.Generator(np.random.Philox(key=[self._epoch, idx]))
            image, label = self.transform(image, label, rng)

        return {
            "image": image,
            "label": label,
            "case_id": case_id,
            "domain": center_code,
            "center_code": center_code,
            "center_id": center_id,
            "index": int(idx),
        }


@register_dataset_builder("hecktor21")
class Hecktor21Builder(BaseDatasetBuilder):
    """Config schema matches reference: src/datasets/hecktor21.py:304-360."""

    def __init__(self, config: ConfigNode):
        super().__init__(config)
        dcfg = require_config(config, "dataset")

        self.manifest_csv = str(require_config(dcfg, "manifest_csv", type_=str))

        exp_shape = get_config(dcfg, "expected_shape", None)
        self.expected_shape = tuple(exp_shape) if exp_shape is not None else None

        self.drop_unlabeled = bool(get_config(dcfg, "drop_unlabeled", True))
        self.strict_label_values = bool(get_config(dcfg, "strict_label_values", True))

        defaults = ManifestSchema()
        self.schema = ManifestSchema(
            patient=str(get_config(dcfg, "patient_col", defaults.patient)),
            status=str(get_config(dcfg, "status_col", defaults.status)),
            ok_status_values=tuple(
                str(x) for x in get_config(dcfg, "ok_status_values", list(defaults.ok_status_values))
            ),
            ct=str(get_config(dcfg, "ct_col", defaults.ct)),
            pt=str(get_config(dcfg, "pt_col", defaults.pt)),
            label=str(get_config(dcfg, "label_col", defaults.label)),
            center_code=str(get_config(dcfg, "center_code_col", defaults.center_code)),
            center_id=str(get_config(dcfg, "center_id_col", defaults.center_id)),
        )
        self.root_dir = get_config(dcfg, "root_dir", None)

        self.cache_in_memory = bool(get_config(dcfg, "cache_in_memory", False))
        self.decode_cache_dir = get_config(dcfg, "decode_cache_dir", None)
        self.target_center = str(require_config(dcfg, "target_center", type_=str))
        self.val_per_center = int(get_config(dcfg, "val_per_center", 5))
        self.split_seed = int(get_config(dcfg, "split_seed", 2026))
        self.channel_names = [str(x) for x in get_config(dcfg, "modality_order", ["ct", "pt"])]

    def build_transform(self, split_norm: str):
        tcfg = get_config(self.config, "training.data.transforms", ConfigNode())
        normalize = bool(require_config(tcfg, "normalize"))
        geom_aug = bool(require_config(tcfg, "geom_aug"))
        intensity_aug = bool(require_config(tcfg, "intensity_aug"))
        mean = get_config(tcfg, "mean", [0.0, 0.0])
        std = get_config(tcfg, "std", [1.0, 1.0])
        intensity_policy = get_config(tcfg, "intensity_policy", None)
        on_device = bool(get_config(tcfg, "on_device", False))

        image_size = get_config(tcfg, "image_size", None)
        if image_size is not None:
            if len(list(image_size)) != 3:
                raise ValueError("[hecktor21] training.data.transforms.image_size must be [D,H,W]")
            image_size = [int(x) for x in list(image_size)]

        return get_seg_transforms(
            ndim=3,
            split=split_norm,
            normalize=normalize,
            geom_aug=geom_aug,
            intensity_aug=intensity_aug,
            mean=mean,
            std=std,
            expected_label_channels=1,
            region_label_as_float=True,
            image_size=image_size,  # shape check only, never resizes
            intensity_policy=intensity_policy,
            channel_names=self.channel_names,
            on_device=on_device,
            modality_dropout=get_config(tcfg, "modality_dropout", None),
        )

    def build_dataset(self, split: str, **overrides) -> Optional[Hecktor21Dataset]:
        split_norm = self._normalize_split(split)
        transform = overrides.get("transform", None)
        if transform is None:
            transform = self.build_transform(split_norm)

        return Hecktor21Dataset(
            manifest_csv=self.manifest_csv,
            split=split_norm,
            target_center=str(overrides.get("target_center", self.target_center)),
            val_per_center=int(overrides.get("val_per_center", self.val_per_center)),
            split_seed=int(overrides.get("split_seed", self.split_seed)),
            expected_shape=overrides.get("expected_shape", self.expected_shape),
            drop_unlabeled=bool(overrides.get("drop_unlabeled", self.drop_unlabeled)),
            strict_label_values=bool(
                overrides.get("strict_label_values", self.strict_label_values)
            ),
            root_dir=overrides.get("root_dir", self.root_dir),
            schema=self.schema,
            transform=transform,
            cache_in_memory=bool(overrides.get("cache_in_memory", self.cache_in_memory)),
            decode_cache_dir=overrides.get("decode_cache_dir", self.decode_cache_dir),
            logger=self.logger,
        )
