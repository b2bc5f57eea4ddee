"""Manifest path resolution shared by the dataset builders (the port's copy
of ``multimodal_tta_tpu/data/manifest.py``).

Dataset manifests (HECKTOR21 CSVs, BraTS processed.csv files) may store
image/label paths either absolute or relative to a configured
``dataset.root_dir``. Both builders funnel every path cell through
:func:`resolve_manifest_path` so that the resolution contract — pinned by
the split-parity tests in tests/test_datasets.py — lives in exactly one
place. Behavioral contract (reference: src/datasets/hecktor21.py:31-38):

- missing cells (``None`` or a NaN float, as ``data/csv_table.py`` reads
  an empty cell) resolve to ``""`` so the
  caller can treat absence uniformly;
- absolute paths pass through untouched, ``root_dir`` or not;
- relative paths are anchored under ``root_dir`` when one is configured,
  and pass through unchanged otherwise.
"""
from __future__ import annotations

import math
import os
from typing import Any, Optional

__all__ = ["resolve_manifest_path"]


def resolve_manifest_path(cell: Any, root_dir: Optional[str]) -> str:
    """Resolve one manifest path cell to a filesystem path (or ``""``)."""
    if cell is None:
        return ""
    if isinstance(cell, float) and math.isnan(cell):
        return ""
    path = str(cell)
    if not path or os.path.isabs(path) or not root_dir:
        return path
    return os.path.join(root_dir, path)
