"""Manifest CSVs read the way the reference's ``pandas.read_csv`` reads them.

The dataset builders of the reference read their manifests with pandas;
the port reads them with the ``csv`` module and matches what the builders
see of pandas' semantics by hand:

  - type inference per column: a column whose filled cells are all integers
    holds ints (floats when a cell is empty), all numbers floats,
    all ``True``/``False`` booleans, anything else strings;
  - empty cells and pandas' default NA strings (``NA``, ``nan``, ``None``,
    ``null``, ...) are NaN;
  - every row keeps its label (its 0-based position in the file), as
    pandas' default index does after filtering.

``str`` of such a cell is pandas' ``astype(str)`` of a filled one (``'1.0'``,
``'True'``); ``notna`` is its ``notna()``. ``write_csv`` writes rows as
``pandas.DataFrame(rows).to_csv(path, index=False)`` does, for the
preparation CLIs' manifests.
"""

from __future__ import annotations

import csv
import math
import re
from typing import Any, Dict, List

# pandas' default ``na_values`` (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT_RE = re.compile(r"[+-]?[0-9]+")
_FLOAT_RE = re.compile(r"[+-]?(?:[0-9]+\.?[0-9]*(?:[eE][+-]?[0-9]+)?|\.[0-9]+(?:[eE][+-]?[0-9]+)?"
                       r"|inf|Inf|INF|infinity|Infinity|INFINITY)")
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})


def _column(raw: List[str]) -> List[Any]:
    """One column's cells, typed as pandas infers them."""
    na = [v in NA_VALUES for v in raw]
    filled = [v for v, n in zip(raw, na) if not n]
    if not filled:
        return [math.nan] * len(raw)
    if all(_INT_RE.fullmatch(v) for v in filled):
        if any(na):
            return [math.nan if n else float(int(v)) for v, n in zip(raw, na)]
        return [int(v) for v in raw]
    if all(_FLOAT_RE.fullmatch(v) for v in filled):
        return [math.nan if n else float(v) for v, n in zip(raw, na)]
    if not any(na) and all(v in _TRUE or v in _FALSE for v in raw):
        return [v in _TRUE for v in raw]
    return [math.nan if n else v for v, n in zip(raw, na)]


class Table:
    """Rows of a CSV as dicts, each with its row label (``index``)."""

    def __init__(self, columns: List[str], rows: List[Dict[str, Any]], index: List[int]):
        self.columns = columns
        self.rows = rows
        self.index = index

    def __len__(self) -> int:
        return len(self.rows)

    def add_column(self, name: str, value: Any) -> None:
        """pandas' ``df[name] = value`` for a scalar."""
        self.columns.append(name)
        for r in self.rows:
            r[name] = value

    def take(self, keep: List[bool]) -> "Table":
        return Table(list(self.columns), [dict(r) for r, k in zip(self.rows, keep) if k],
                     [i for i, k in zip(self.index, keep) if k])


def read_csv(path: str) -> Table:
    with open(path, newline="", encoding="utf-8") as f:
        records = list(csv.reader(f))
    if not records:
        raise ValueError(f"{path}: no header row")
    columns, body = records[0], [r for r in records[1:] if r]
    for r in body:
        if len(r) > len(columns):
            raise ValueError(f"{path}: a row has {len(r)} fields, the header {len(columns)}")
    cells = [_column([r[j] if j < len(r) else "" for r in body]) for j in range(len(columns))]
    rows = [{c: cells[j][i] for j, c in enumerate(columns)} for i in range(len(body))]
    return Table(list(columns), rows, list(range(len(body))))


def notna(value: Any) -> bool:
    return value is not None and not (isinstance(value, float) and math.isnan(value))


def _is_number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def write_csv(path: str, rows: List[Dict[str, Any]]) -> None:
    """``pandas.DataFrame(rows).to_csv(path, index=False)``: the columns in the
    order they first appear, an absent or NaN cell empty; a column of numbers
    with a float or an empty cell is pandas' float64 (each number as its float
    repr, ``1`` as ``1.0``), any other cell ``str``; quoting as the ``csv``
    module's, ``\\n`` line ends."""
    columns: List[str] = []
    for r in rows:
        columns += [k for k in r if k not in columns]
    as_float = {}
    for c in columns:
        cells = [r.get(c) for r in rows]
        filled = [v for v in cells if notna(v)]
        as_float[c] = all(_is_number(v) for v in filled) and (len(filled) < len(cells) or any(
            isinstance(v, float) for v in filled))

    def cell(c: str, v: Any) -> str:
        if not notna(v):
            return ""
        return repr(float(v)) if as_float[c] else str(v)

    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        if not columns:
            f.write("\n")
            return
        w.writerow(columns)
        w.writerows([cell(c, r.get(c)) for c in columns] for r in rows)
