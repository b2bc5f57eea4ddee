"""The reference's sharded orbax checkpoint format (``path.orbax/``, what
``orbax.checkpoint.StandardCheckpointer`` writes for the reference's
``save_checkpoint_sharded``), read and written without orbax, tensorstore
or zstd packages.

The layout, as orbax-checkpoint 0.11.32 over tensorstore 0.1.80 writes it:

  * ``_METADATA`` (JSON): ``tree_metadata``, one entry per leaf of the
    payload keyed by ``str`` of its key-path tuple, with each key's
    ``key_type`` (1 a tuple index, 2 a dict key or a NamedTuple field) and
    its ``value_metadata``: ``jax.Array`` with its ``write_shape``, or an
    empty node (``Dict`` for ``{}``, ``Tuple`` for ``()``, ``None`` for an
    optax ``EmptyState``) with ``skip_deserialize``; ``use_ocdbt`` true,
    ``use_zarr3`` false.
  * ``_CHECKPOINT_METADATA`` (JSON), ``_sharding`` (JAX's shardings) and
    ``array_metadatas/process_<N>`` (JSON: each array's write and chunk
    shape). The reference's restore reads only ``_METADATA`` and the
    database; the port writes ``_METADATA``, ``_CHECKPOINT_METADATA`` and
    ``array_metadatas/process_<N>``, and no ``_sharding`` (it names JAX
    devices).
  * the OCDBT database (``core/ocdbt.py``): each process writes its own
    ``ocdbt.process_<N>/``, and the top-level ``manifest.ocdbt`` and tree
    name every key, its value inline (at most 1024 bytes) or in a
    process's data file.
  * each array leaf is a zarr v2 array under its param name, the key path
    joined by ``.`` (``params.enc0.unit0.conv.kernel``,
    ``opt_state.1.0.mu.enc0...``): ``<name>/.zarray`` (JSON: shape, chunk
    shape, dtype ``<f4`` / ``<f2`` / ``<i4`` / ``<i8`` / ``|b1`` /
    ``bfloat16`` / ..., ``"compressor": {"id": "zstd", "level": 1}``,
    ``"dimension_separator": "."``, C order, ``"fill_value": null``) and
    one key per chunk, ``<name>/<i>.<j>...`` (``<name>/0`` for a 0-d
    leaf), each a zstd frame of the chunk's C-order bytes. An edge chunk is
    stored whole, padded with zeros. A leaf sharded over a mesh axis has
    one chunk per shard.

``load`` returns the nested payload ``flax_msgpack.load`` returns for the
same state (``{step, params, batch_stats, opt_state[, ema_params]}``,
tuples as ``{"0": ...}``, NamedTuples by field, empty nodes as ``{}``,
arrays as CPU tensors, ``bfloat16`` as its ``uint16`` bits viewed as
``torch.bfloat16``), so the rest of ``core/checkpoint.py`` reads both
formats alike. Chunks are read and decoded on a pool of ``THREADS`` threads
(the native decoder of ``core/zstd.py`` drops the GIL). A chunk missing from
the grid raises where ``_METADATA`` says every chunk was stored
(``store_array_data_equal_to_fill_value``, as orbax and the port write it),
and reads as zeros, the fill value, where it does not.

``flatten`` lays a payload (``core/checkpoint.py:_msgpack_payload``: a
``TupleFields`` is a tuple, another ``Fields`` a NamedTuple, a dict a
dict) out as leaves; ``write_process`` writes one process's chunks and
``finalize`` (process 0, after every process has written) the top level,
as orbax's finalisation does (``core/checkpoint.py`` runs them over the
ranks), and ``commit`` puts the finished directory in place. The port's
chunk frames are raw and RLE blocks (``zstd.frame_pieces``), so its files
are larger than the reference's level-1 frames and not the same bytes;
every zstd decoder reads them.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ocdbt, zstd
from .flax_msgpack import Fields, TupleFields

SEQUENCE_KEY, DICT_KEY = 1, 2
EMPTY_TYPES = ("Dict", "Tuple", "None")
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
THREADS = min(8, os.cpu_count() or 1)  # the chunk decoding pool

_ZARR_DTYPES = {
    "<f8": torch.float64, "<f4": torch.float32, "<f2": torch.float16, "bfloat16": torch.bfloat16,
    "<i8": torch.int64, "<i4": torch.int32, "<i2": torch.int16, "|i1": torch.int8,
    "<u8": torch.uint64, "<u4": torch.uint32, "<u2": torch.uint16, "|u1": torch.uint8, "|b1": torch.bool,
    "<c8": torch.complex64, "<c16": torch.complex128,
}
_ZARR_NAMES = {v: k for k, v in _ZARR_DTYPES.items()}


class OrbaxError(ValueError):
    """A checkpoint this reader does not understand, or a malformed one."""


Keys = Tuple[Tuple[str, int], ...]  # (key, key_type) from the root


@dataclasses.dataclass
class Leaf:
    """One leaf of the tree: an array (``shape``, ``dtype``, ``chunks``:
    the chunk shape) with the chunks this process writes (``pieces``:
    chunk index -> tensor of the chunk's shape, an edge chunk's cut to the
    array), or an empty node (``empty`` its value type)."""

    keys: Keys
    shape: Tuple[int, ...] = ()
    dtype: Optional[torch.dtype] = None
    chunks: Tuple[int, ...] = ()
    pieces: Dict[Tuple[int, ...], Any] = dataclasses.field(default_factory=dict)
    empty: Optional[str] = None

    @property
    def name(self) -> str:
        return ".".join(k for k, _ in self.keys)


# ---------------------------------------------------------------------------
# the payload as leaves


def _empty_type(node) -> str:
    if isinstance(node, TupleFields):
        return "Tuple"
    if isinstance(node, Fields):
        return "None"  # an optax EmptyState, a NamedTuple without fields
    return "Dict"


def flatten(payload, keys: Keys = ()) -> Iterator[Tuple[Keys, Any]]:
    """``(keys, value)`` per leaf of ``payload`` in orbax's order (a dict's
    keys sorted, a ``Fields``' in order); an empty node's value is its
    value type (``"Dict"``, ``"Tuple"`` or ``"None"``)."""
    if isinstance(payload, dict):
        if not payload:
            yield keys, _empty_type(payload)
            return
        kind = SEQUENCE_KEY if isinstance(payload, TupleFields) else DICT_KEY
        items = payload.items() if isinstance(payload, Fields) else sorted(payload.items())
        for k, v in items:
            yield from flatten(v, keys + ((str(k), kind),))
        return
    yield keys, payload


def as_tensor(x) -> torch.Tensor:
    """A payload leaf (a tensor, an ndarray or a numpy scalar) as a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.array(x))  # a copy that keeps a 0-d array 0-d


def whole_leaves(payload) -> List[Leaf]:
    """Every leaf of ``payload`` as one chunk, all written by this process."""
    out = []
    for keys, v in flatten(payload):
        if isinstance(v, str):
            out.append(Leaf(keys, empty=v))
            continue
        t = as_tensor(v)
        out.append(Leaf(keys, tuple(t.shape), t.dtype, tuple(t.shape), {(0,) * t.dim(): t}))
    return out


# ---------------------------------------------------------------------------
# writing


def _zarray(leaf: Leaf) -> bytes:
    if leaf.dtype not in _ZARR_NAMES:
        raise OrbaxError(f"[orbax] no zarr dtype for {leaf.dtype} ({leaf.name})")
    meta = {"chunks": list(leaf.chunks), "compressor": {"id": "zstd", "level": 1}, "dimension_separator": ".",
            "dtype": _ZARR_NAMES[leaf.dtype], "fill_value": None, "filters": None, "order": "C",
            "shape": list(leaf.shape), "zarr_format": 2}
    return json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()


def _chunk_key(leaf: Leaf, index: Tuple[int, ...]) -> bytes:
    return f"{leaf.name}/{'.'.join(str(i) for i in index) if index else '0'}".encode()


def _chunk_bytes(leaf: Leaf, index: Tuple[int, ...], piece) -> np.ndarray:
    """The chunk's C-order bytes on the host, an edge chunk padded with
    zeros to the whole chunk shape."""
    t = as_tensor(piece).to("cpu")
    want = tuple(min(c, s - i * c) for s, c, i in zip(leaf.shape, leaf.chunks, index))
    if tuple(t.shape) != want:
        raise OrbaxError(f"[orbax] chunk {index} of {leaf.name} is {tuple(t.shape)}, {want} expected")
    if t.dtype != leaf.dtype:
        raise OrbaxError(f"[orbax] chunk {index} of {leaf.name} is {t.dtype}, {leaf.dtype} expected")
    if want != tuple(leaf.chunks):
        full = torch.zeros(leaf.chunks, dtype=t.dtype)
        full[tuple(slice(0, w) for w in want)] = t
        t = full
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.uint16)
    return t.reshape(-1).view(torch.uint8).numpy()


def write_process(directory: str, leaves: Sequence[Leaf], process: int = 0, write_zarray: bool = True) -> None:
    """Write this process's chunks of ``leaves`` (and, with
    ``write_zarray``, every array's ``.zarray``) as
    ``directory/ocdbt.process_<process>/`` and its
    ``array_metadatas/process_<process>``."""

    def items():
        for leaf in leaves:
            if leaf.empty is not None:
                continue
            if write_zarray:
                yield f"{leaf.name}/.zarray".encode(), _zarray(leaf)
            for index, piece in sorted(leaf.pieces.items()):
                yield _chunk_key(leaf, index), zstd.frame_pieces(_chunk_bytes(leaf, index, piece))

    ocdbt.write_database(os.path.join(directory, f"ocdbt.process_{process}"), items())
    meta = {"array_metadatas": [
        {"array_metadata": {"param_name": leaf.name, "write_shape": list(leaf.chunks),
                            "chunk_shape": list(leaf.chunks), "ext_metadata": None}}
        for leaf in leaves if leaf.empty is None and leaf.pieces]}
    os.makedirs(os.path.join(directory, "array_metadatas"), exist_ok=True)
    with open(os.path.join(directory, "array_metadatas", f"process_{process}"), "w", encoding="utf-8") as f:
        json.dump(meta, f)


def tree_metadata(leaves: Sequence[Leaf]) -> Dict[str, Any]:
    out = {}
    for leaf in leaves:
        if leaf.empty is not None:
            value = {"value_type": leaf.empty, "skip_deserialize": True}
        else:
            value = {"value_type": "jax.Array", "skip_deserialize": False, "write_shape": list(leaf.chunks)}
        out[str(tuple(k for k, _ in leaf.keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in leaf.keys], "value_metadata": value}
    return out


def finalize(directory: str, leaves: Sequence[Leaf], processes: int = 1, init_ns: Optional[int] = None) -> None:
    """Process 0's part once every process has written: the top-level tree
    over each ``ocdbt.process_<N>``, ``_METADATA`` and
    ``_CHECKPOINT_METADATA``."""
    entries = []
    for p in range(processes):
        entries += ocdbt.entries_as_refs(directory, f"ocdbt.process_{p}/")
    ocdbt.write_database(directory, entries)
    meta = {"tree_metadata": tree_metadata(leaves), "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}
    with open(os.path.join(directory, "_METADATA"), "w", encoding="utf-8") as f:
        json.dump(meta, f)
    now = time.time_ns()
    with open(os.path.join(directory, "_CHECKPOINT_METADATA"), "w", encoding="utf-8") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": init_ns or now, "commit_timestamp_nsecs": now,
                   "custom_metadata": {}}, f)


def old_of(final: str) -> str:
    """Where ``commit`` keeps the earlier checkpoint while it replaces
    ``final``."""
    return final + ".old"


def commit(tmp: str, final: str) -> None:
    """Put the finished directory ``tmp`` in the place of ``final`` (an
    earlier checkpoint there is replaced, as orbax's ``force=True`` does).
    Two renames, not one: an earlier ``final`` is first moved to
    ``final.old``, which is removed only once ``tmp`` stands as ``final``.
    A save cut short before the first rename leaves ``final`` as it was;
    one cut between the two leaves no ``final`` but the earlier checkpoint
    whole in ``final.old``, which ``old_of`` names and the next commit
    keeps until its own ``tmp`` is in place."""
    old = old_of(final)
    if os.path.exists(final):
        if os.path.exists(old):
            shutil.rmtree(old)
        os.replace(final, old)
    os.replace(tmp, final)
    if os.path.exists(old):
        shutil.rmtree(old)


# ---------------------------------------------------------------------------
# reading


def _insert(out: dict, keys: Sequence[str], value) -> None:
    node = out
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def read_metadata(directory: str) -> Dict[str, Any]:
    path = os.path.join(directory, "_METADATA")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"[orbax] no _METADATA in {directory}: not a StandardCheckpointer checkpoint")
    with open(path, "r", encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxError(f"[orbax] {directory} holds zarr3 arrays; the reference writes zarr v2 (use_zarr3 false)")
    if meta.get("use_ocdbt") is False:
        raise OrbaxError(f"[orbax] {directory} is not an OCDBT checkpoint (use_ocdbt false)")
    return meta


class _ArrayReader:
    """One array leaf: its ``.zarray``, its chunks' entries, and the jobs
    that decode them into one tensor."""

    def __init__(self, db: ocdbt.Database, name: str, zarray: bytes, entries: Dict[bytes, ocdbt.Entry],
                 complete: bool):
        meta = json.loads(zarray)
        if meta.get("zarr_format") != 2:
            raise OrbaxError(f"[orbax] {name} is zarr format {meta.get('zarr_format')}")
        if meta.get("order", "C") != "C" or meta.get("filters"):
            raise OrbaxError(f"[orbax] {name}: order {meta.get('order')} and filters {meta.get('filters')}")
        compressor = meta.get("compressor") or {}
        if compressor.get("id") != "zstd":
            raise OrbaxError(f"[orbax] {name} is compressed with {compressor.get('id')}; the reference uses zstd")
        if meta["dtype"] not in _ZARR_DTYPES:
            raise OrbaxError(f"[orbax] {name} has zarr dtype {meta['dtype']!r}")
        fill = meta.get("fill_value")
        if fill not in (None, 0, 0.0, False):
            raise OrbaxError(f"[orbax] {name} has fill value {fill!r}")
        self.db, self.name, self.complete = db, name, complete
        self.shape, self.chunks = tuple(meta["shape"]), tuple(meta["chunks"])
        self.sep = meta.get("dimension_separator", ".")
        self.dtype = _ZARR_DTYPES[meta["dtype"]]
        self.out = torch.zeros(self.shape, dtype=self.dtype)  # the fill value, where a chunk may be missing
        self.entries = entries
        self.itemsize = torch.empty((), dtype=self.dtype).element_size()

    def jobs(self) -> List[Tuple[Tuple[int, ...], ocdbt.Entry]]:
        grid = [range(-(-s // c)) if c else range(1) for s, c in zip(self.shape, self.chunks)]
        out = []
        for index in np.ndindex(*[len(g) for g in grid]) if self.shape else [()]:
            key = f"{self.name}/{self.sep.join(str(i) for i in index) if index else '0'}".encode()
            if key in self.entries:
                out.append((tuple(index), self.entries[key]))
            elif self.complete:
                raise OrbaxError(f"[orbax] chunk {tuple(index)} of {self.name} is missing, and _METADATA says "
                                 "every chunk was stored (store_array_data_equal_to_fill_value)")
        return out

    def decode(self, index: Tuple[int, ...], entry: ocdbt.Entry) -> int:
        raw = self.db.read(entry)
        nbytes = math.prod(self.chunks) * self.itemsize
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, self.chunks, self.shape))
        whole = tuple(self.chunks) == self.shape
        bits = self.out.view(torch.uint16) if self.dtype == torch.bfloat16 else self.out
        target = bits if whole else torch.empty(self.chunks, dtype=bits.dtype)
        buf = target.reshape(-1).view(torch.uint8).numpy() if nbytes else np.empty(0, np.uint8)
        got = zstd.decompress_into(raw, buf) if nbytes else zstd.decompress_into(raw, bytearray(1))
        if got != nbytes:
            raise OrbaxError(f"[orbax] chunk {index} of {self.name} holds {got} bytes, {nbytes} expected")
        if not whole:
            bits[region] = target[tuple(slice(0, r.stop - r.start) for r in region)]
        return nbytes


def load(directory: str, stats: Optional[dict] = None) -> Dict[str, Any]:
    """The payload of the orbax checkpoint ``directory`` (``path.orbax``),
    as ``flax_msgpack.load`` gives it. ``stats``, when given, receives the
    bytes decoded and the seconds the chunk decoding took."""
    meta = read_metadata(directory)
    with ocdbt.Database(directory) as db:
        by_name: Dict[str, Dict[bytes, ocdbt.Entry]] = {}
        for e in db.entries():
            by_name.setdefault(e.key.rpartition(b"/")[0].decode(), {})[e.key] = e
        out: Dict[str, Any] = {}
        readers = []
        for rec in meta["tree_metadata"].values():
            keys = [str(k["key"]) for k in rec["key_metadata"]]
            value = rec["value_metadata"]
            if value.get("skip_deserialize"):
                if value.get("value_type") not in EMPTY_TYPES:
                    raise OrbaxError(f"[orbax] {'.'.join(keys)} is a {value.get('value_type')} the reference "
                                     "does not write")
                _insert(out, keys, {})
                continue
            name = ".".join(keys)
            own = by_name.get(name, {})
            zarray = own.get(f"{name}/.zarray".encode())
            if zarray is None:
                raise OrbaxError(f"[orbax] {directory} has no {name}/.zarray")
            reader = _ArrayReader(db, name, db.read(zarray), own,
                                  bool(meta.get("store_array_data_equal_to_fill_value")))
            readers.append(reader)
            _insert(out, keys, reader.out)
        jobs = [(r, index, e) for r in readers for index, e in r.jobs()]
        start = time.perf_counter()
        with ThreadPoolExecutor(max_workers=THREADS) as pool:
            decoded = sum(pool.map(lambda j: j[0].decode(j[1], j[2]), jobs))
        if stats is not None:
            stats.update(bytes=decoded, decode_s=time.perf_counter() - start, chunks=len(jobs))
    return out


__all__ = ["THREADS", "Leaf", "OrbaxError", "as_tensor", "commit", "finalize", "flatten", "load", "old_of",
           "read_metadata", "tree_metadata", "whole_leaves", "write_process"]
