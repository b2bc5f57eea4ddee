"""BraTS (GLI / SSA / PED) multi-source NIfTI dataset (the port of
``multimodal_tta_tpu/data/brats.py``).

The per-source CSVs are read by ``data/csv_table.py`` instead of pandas;
the grouping by subject keeps first-seen order and drops rows without a
subject (pandas' ``groupby(sort=False)``), and an empty cell is NaN
(``pd.notna``), as in the reference.

Capability parity with the reference multi-source dataset (reference:
src/datasets/brats.py:260-575): per-source processed.csv manifests with an
explicit split column, modality completeness + unlabeled-drop filters, fixed
region order ET/TC/WT, per-profile raw-label -> region maps, and per-sample
domain/profile tags for per-domain evaluation under domain shift.

Sample layout (TPU-native channels-last):
  image: float32 [D, H, W, 4]  (D=Z, H=Y, W=X; channels t1n,t1c,t2w,t2f)
  label: float32 [D, H, W, 3]  (region masks, ET/TC/WT order)
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
from .csv_table import notna, read_csv
from .manifest import resolve_manifest_path
from .nifti import DecodedCache, DiskDecodedCache, load_canonical_dhw
from .transforms import get_seg_transforms

REGION_ORDER: List[str] = ["ET", "TC", "WT"]
EXPECTED_REGION_CHANNELS: int = 3

# Per-profile raw-label taxonomies (reference: src/datasets/brats.py:58-77):
#   gli/ssa: NETC=1, SNFH=2, ET=3 (gli may also carry RC=4, ignored by default)
#   ped:     ET=1, NET=2, CC=3, ED=4
DEFAULT_REGION_MAPS: Dict[str, Dict[str, List[int]]] = {
    "gli": {"ET": [3], "TC": [1, 3], "WT": [1, 2, 3]},
    "ssa": {"ET": [3], "TC": [1, 3], "WT": [1, 2, 3]},
    "ped": {"ET": [1], "TC": [1, 2, 3], "WT": [1, 2, 3, 4]},
}


def safe_round_label(label: np.ndarray, tol: float = 1e-3) -> np.ndarray:
    """Round float labels to ints (non-integer values signal a bad resample
    upstream; reference: src/datasets/brats.py:95-111)."""
    if label.dtype.kind in ("i", "u"):
        return label.astype(np.int16, copy=False)
    rounded = np.rint(label)
    return rounded.astype(np.int16, copy=False)


def build_region_masks_from_raw(
    y_id: np.ndarray, region_map: Dict[str, Sequence[int]]
) -> np.ndarray:
    """Raw id map [D,H,W] int -> region masks [D,H,W,R] float32 in REGION_ORDER."""
    masks: List[np.ndarray] = []
    for rname in REGION_ORDER:
        vals = list(region_map.get(rname, []))
        if not vals:
            masks.append(np.zeros(y_id.shape, dtype=np.float32))
            continue
        m = np.isin(y_id, np.asarray(vals, dtype=y_id.dtype))
        masks.append(m.astype(np.float32))
    return np.stack(masks, axis=-1)


@dataclass(frozen=True)
class SourceSpec:
    name: str
    csv_path: str
    profile: str
    root_dir: Optional[str]
    include_splits: Dict[str, List[str]]
    region_map: Dict[str, List[int]]


def parse_processed_csv_to_cases(
    csv_path: str,
    modality_order: Sequence[str],
    *,
    root_dir: Optional[str],
    drop_unlabeled: bool,
    split_col: str = "split",
    subject_col: str = "subject_id",
    modality_col: str = "modality",
    img_col: str = "img_path",
    label_col: str = "label_path",
    logger=None,
) -> Dict[str, Dict[str, Any]]:
    """Assemble per-case records from a long-format CSV (one row per
    subject×modality).

    Pinned behavioral contract (reference semantics: src/datasets/brats.py
    170-253, exercised by tests/test_datasets.py): a case's split and label
    come from its FIRST row carrying one (later disagreements warn and are
    ignored), the last row per modality wins, and a case survives only with
    every modality in ``modality_order`` present (plus a label when
    ``drop_unlabeled``). Case order follows first appearance in the CSV.
    """
    logger = logger or get_logger()
    table = read_csv(csv_path)

    absent = [c for c in (subject_col, modality_col, img_col, split_col) if c not in table.columns]
    if absent:
        raise ValueError(f"[BraTS] {csv_path} lacks required column(s) {absent}")
    if label_col not in table.columns:
        table.add_column(label_col, np.nan)

    wanted = [m.lower() for m in modality_order]
    records: Dict[str, Dict[str, Any]] = {}
    n_incomplete = 0
    n_unlabeled = 0

    groups: Dict[Any, List[Dict[str, Any]]] = {}
    for row in table.rows:
        if notna(row[subject_col]):  # groupby drops NaN keys
            groups.setdefault(row[subject_col], []).append(row)

    for case_id, rows in groups.items():
        case_id = str(case_id)

        splits = [str(r[split_col]).strip().lower() for r in rows]
        split = splits[0]
        if any(sp != split for sp in splits):
            logger.warning(
                f"[BraTS] case '{case_id}' appears under several split values "
                f"{sorted(set(splits))}; keeping the first ('{split}')"
            )

        label = ""
        for cell in (r[label_col] for r in rows):
            p = resolve_manifest_path(cell, root_dir) if notna(cell) else ""
            if not p:
                continue
            if not label:
                label = p
            elif p != label:
                logger.warning(
                    f"[BraTS] case '{case_id}' lists multiple label paths; keeping the first"
                )

        mods: Dict[str, str] = {}
        for r in rows:
            mods[str(r[modality_col]).strip().lower()] = resolve_manifest_path(r[img_col], root_dir)

        if any(m not in mods for m in wanted):
            n_incomplete += 1
            continue
        if drop_unlabeled and not label:
            n_unlabeled += 1
            continue
        records[case_id] = {"split": split, "modalities": mods, "label": label}

    logger.info(
        f"[BraTS] {csv_path}: kept {len(records)} of "
        f"{len(records) + n_incomplete + n_unlabeled} cases "
        f"(dropped {n_incomplete} incomplete-modality, {n_unlabeled} unlabeled)"
    )
    return records


class BratsMultiSourceNiftiDataset:
    def __init__(
        self,
        sources: List[SourceSpec],
        split: str,
        modality_order: Sequence[str] = ("t1n", "t1c", "t2w", "t2f"),
        expected_shape: Optional[Tuple[int, int, int]] = None,
        drop_unlabeled: bool = True,
        transform: Optional[Callable] = None,
        logger=None,
        strict_label_values: bool = False,
        cache_in_memory: bool = False,
        decode_cache_dir: Optional[str] = None,
    ):
        self.logger = logger or get_logger()
        self.split = str(split).lower()
        self.modality_order = [m.lower() for m in modality_order]
        self.expected_shape = tuple(expected_shape) if expected_shape is not None else None
        self.drop_unlabeled = bool(drop_unlabeled)
        self.transform = transform
        self.strict_label_values = bool(strict_label_values)
        self._cache = (
            DecodedCache()
            if cache_in_memory
            else (DiskDecodedCache(decode_cache_dir) if decode_cache_dir else None)
        )
        self._epoch = 0

        self._index: List[Tuple[SourceSpec, str, Dict[str, Any]]] = []
        for src in sources:
            if not os.path.exists(src.csv_path):
                raise FileNotFoundError(f"[BraTS] CSV not found: {src.csv_path}")
            cases = parse_processed_csv_to_cases(
                csv_path=src.csv_path,
                modality_order=self.modality_order,
                root_dir=src.root_dir,
                drop_unlabeled=self.drop_unlabeled,
                logger=self.logger,
            )
            include_vals = [str(v).lower() for v in src.include_splits.get(self.split, [self.split])]
            for case_id, info in cases.items():
                if str(info["split"]).lower() in include_vals:
                    self._index.append((src, case_id, info))

        if not self._index:
            raise ValueError(
                f"[BraTS] No samples after filtering. split='{self.split}'. "
                f"Check include_splits and CSV 'split' values."
            )
        self.logger.info(
            f"[BraTS] Built dataset: split='{self.split}', n={len(self._index)}, "
            f"sources={[s.name for s in sources]}"
        )

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return len(self._index)

    def source_geometry(self, idx: int):
        """(canonical RAS+ affine, (X,Y,Z) shape) of the case's grid, from the
        first modality volume's header — the geometry predictions are written
        back into. Header-only (no voxel decode)."""
        from .nifti import peek_canonical_geometry

        src, case_id, info = self._index[idx]
        path = info["modalities"][self.modality_order[0]]
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"[BraTS] Missing image file for geometry: {path} (case={case_id})"
            )
        return peek_canonical_geometry(path)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        src, case_id, info = self._index[idx]

        vols: List[np.ndarray] = []
        for mod in self.modality_order:
            p = info["modalities"][mod]
            if not os.path.exists(p):
                raise FileNotFoundError(f"[BraTS] Missing image file: {p} (case={case_id}, mod={mod})")
            load = self._cache.get_or_load if self._cache is not None else load_canonical_dhw
            vol = load(p)  # fused decode to (D,H,W)=(Z,Y,X)
            self._validate_shape_dhw(vol, f"image/{mod}", case_id)
            vols.append(vol)

        image = np.stack(vols, axis=-1)  # [D,H,W,C]

        label_path = info.get("label", "")
        if (not label_path) or (not os.path.exists(label_path)):
            y_np = np.zeros(image.shape[:3], dtype=np.int16)
        else:
            load = self._cache.get_or_load if self._cache is not None else load_canonical_dhw
            y = load(label_path)
            self._validate_shape_dhw(y, "label", case_id)
            y_np = safe_round_label(y)  # [D,H,W]

        if self.strict_label_values:
            uniq = np.unique(y_np)
            bad = [int(v) for v in uniq.tolist() if v < 0 or v > 20]
            if bad:
                raise ValueError(
                    f"[BraTS] case={case_id} src={src.name} carries out-of-range "
                    f"label ids {bad} (expected small non-negative ints) — check "
                    f"that the preprocessing resampled labels with nearest-"
                    f"neighbor interpolation."
                )

        y_reg = build_region_masks_from_raw(y_np.astype(np.int64), src.region_map)  # [D,H,W,3]

        if self.transform is not None:
            rng = np.random.Generator(np.random.Philox(key=[self._epoch, idx]))
            image, y_reg = self.transform(image, y_reg, rng)

        if y_reg.ndim != 4 or int(y_reg.shape[-1]) != EXPECTED_REGION_CHANNELS:
            raise ValueError(
                f"[BraTS] Region label shape must be [D,H,W,3], got {tuple(y_reg.shape)} "
                f"(case={case_id}, src={src.name})"
            )

        return {
            "image": image,
            "label": y_reg,
            "case_id": case_id,
            "domain": src.name,
            "profile": src.profile,
            "index": int(idx),
        }

    def _validate_shape_dhw(self, arr: np.ndarray, what: str, case_id: str) -> None:
        """expected_shape is configured as (X,Y,Z); arrays are (D,H,W)=(Z,Y,X)."""
        if self.expected_shape is None:
            return
        if tuple(arr.shape) != self.expected_shape[::-1]:
            raise ValueError(
                f"[BraTS] Shape mismatch for {what} case={case_id}: got (Z,Y,X)={tuple(arr.shape)}, "
                f"expected (X,Y,Z)={self.expected_shape}."
            )


@register_dataset_builder("brats")
class BratsMultiNiftiBuilder(BaseDatasetBuilder):
    """Config schema matches reference: src/datasets/brats.py:408-497."""

    def __init__(self, config: ConfigNode):
        super().__init__(config)
        dcfg = require_config(config, "dataset")

        exp_shape = get_config(dcfg, "expected_shape", None)
        self.expected_shape = tuple(exp_shape) if exp_shape is not None else None
        self.strict_label_values = bool(get_config(dcfg, "strict_label_values", False))
        self.cache_in_memory = bool(get_config(dcfg, "cache_in_memory", False))
        self.decode_cache_dir = get_config(dcfg, "decode_cache_dir", None)

        raw_sources = get_config(dcfg, "sources", None)
        if raw_sources is None:
            raise ValueError("[brats] config has no 'dataset.sources' list — at least one source spec is needed.")
        self.sources: List[SourceSpec] = [self._source_from_config(node) for node in raw_sources]
        self.modality_order = ("t1n", "t1c", "t2w", "t2f")

    @staticmethod
    def _source_from_config(node) -> SourceSpec:
        """One ``dataset.sources[i]`` entry -> an immutable SourceSpec."""

        def as_plain(x):
            return x.to_container() if hasattr(x, "to_container") else x

        tumor_profile = str(get_config(node, "profile", "gli")).lower()

        # split routing: lowercase everything; absent splits route to themselves
        routing = {
            str(k).lower(): [str(v).lower() for v in list(vals)]
            for k, vals in dict(as_plain(get_config(node, "include_splits", ConfigNode()))).items()
        }
        for canonical in ("train", "val", "test"):
            routing.setdefault(canonical, [canonical])

        # raw-id -> region taxonomy: explicit override beats the profile default
        taxonomy = as_plain(get_config(node, "region_map", None))
        if taxonomy is None:
            taxonomy = DEFAULT_REGION_MAPS.get(tumor_profile, DEFAULT_REGION_MAPS["gli"])
        taxonomy = {region: [int(v) for v in list(ids)] for region, ids in dict(taxonomy).items()}

        return SourceSpec(
            name=str(require_config(node, "name", type_=str)),
            csv_path=str(require_config(node, "csv_path", type_=str)),
            profile=tumor_profile,
            root_dir=get_config(node, "root_dir", None),
            include_splits=routing,
            region_map=taxonomy,
        )

    def build_transform(self, split_norm: str):
        tcfg = get_config(self.config, "training.data.transforms", ConfigNode())

        crop = get_config(tcfg, "image_size", None)
        if crop is not None:
            crop = [int(x) for x in list(crop)]
            if len(crop) != 3:
                raise ValueError("[brats] training.data.transforms.image_size must be [D,H,W]")

        return get_seg_transforms(
            ndim=3,
            split=split_norm,
            # the three aug/normalize switches are REQUIRED in config — the
            # task yaml must take an explicit position on each
            **{k: bool(require_config(tcfg, k)) for k in ("normalize", "geom_aug", "intensity_aug")},
            mean=get_config(tcfg, "mean", [0.0] * 4),
            std=get_config(tcfg, "std", [1.0] * 4),
            expected_label_channels=EXPECTED_REGION_CHANNELS,
            region_label_as_float=True,
            image_size=crop,
            intensity_policy=get_config(tcfg, "intensity_policy", None),
            channel_names=list(self.modality_order),
            on_device=bool(get_config(tcfg, "on_device", False)),
            modality_dropout=get_config(tcfg, "modality_dropout", None),
        )

    def build_dataset(self, split: str, **overrides) -> Optional[BratsMultiSourceNiftiDataset]:
        split_norm = self._normalize_split(split)

        # Short-circuit splits disabled for all sources (reference: brats.py:506-520)
        enabled = any(
            len(s.include_splits.get(split_norm, [])) > 0 for s in self.sources
        )
        if not enabled:
            self.logger.warning(
                f"[brats] every source excludes split='{split_norm}' via include_splits — "
                f"no dataset to build."
            )
            return None

        transform = overrides.get("transform", None)
        if transform is None:
            transform = self.build_transform(split_norm)

        return BratsMultiSourceNiftiDataset(
            sources=self.sources,
            split=split_norm,
            modality_order=self.modality_order,
            expected_shape=overrides.get("expected_shape", self.expected_shape),
            drop_unlabeled=True,
            transform=transform,
            logger=self.logger,
            strict_label_values=bool(
                overrides.get("strict_label_values", self.strict_label_values)
            ),
            cache_in_memory=bool(overrides.get("cache_in_memory", self.cache_in_memory)),
            decode_cache_dir=overrides.get("decode_cache_dir", self.decode_cache_dir),
        )
