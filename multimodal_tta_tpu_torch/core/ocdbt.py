"""Tensorstore's OCDBT key-value store, read and written (the database
under the reference's orbax checkpoints; no tensorstore package).

A database is a directory. Its ``manifest.ocdbt`` holds the config and the
newest versions, each the root of a B+tree; the tree's nodes and the values
too large to keep inline lie in data files ``d/<hex>``. Every manifest,
B+tree node and version-tree node is framed alike:

    magic            uint32, big-endian (0x0cdb3a2a manifest, 0x0cdb20de
                     B+tree node, 0x0cdb1234 version-tree node)
    length           uint64, the whole framed length
    version          varint, 0
    compression      varint, 0 none or 1 zstd (the body is one zstd frame)
    body
    crc32c           uint32, CRC-32C of everything before it

All integers are little-endian, varints LEB128. The body's parts, as
tensorstore 0.1.80 writes them:

  * config: a 16-byte uuid; manifest kind (0 single, 1 numbered: the
    versions then lie in ``manifest.<16 hex digits>``, the highest the
    newest); ``max_inline_value_bytes``; ``max_decoded_node_bytes``;
    ``version_tree_arity_log2`` (a byte); compression (0 none, 1 zstd then
    an int32 level).
  * data-file table: a count, then each path's length shared with the
    previous path, its suffix's length and its base path's length, then the
    suffixes. A file is ``base_path + relative_path``, both relative to
    the database's directory (orbax's top-level tree names the files of
    ``ocdbt.process_<N>/``).
  * a manifest after its config: the data-file table; the newest versions
    (generation, root height, the root's file / offset / length, its key,
    tree-byte and indirect-byte counts, the commit time in ns); the
    version-tree nodes that hold the older ones. Each set of fields is
    stored column by column. An empty tree's root has offset and length
    2**64 - 1.
  * a B+tree node: its height, its data-file table and its entries. Keys are
    prefix-compressed against the previous entry. A leaf's entries have a
    value length and a kind (0 inline, 1 a reference into a data file,
    then the file and offset). An interior node's entries name their child
    (file, offset, length, its statistics) and the length of the prefix
    every key under it shares, which that child's keys leave out.

The CRC is checked on every read and a mismatch raises.

``write_database`` writes one database with a single version: values
longer than ``max_inline_value_bytes`` go into one data file, followed by
the B+tree's nodes, split into levels where a node would exceed
``max_decoded_node_bytes``. A value may also be a ``Ref`` into a file that
is already on disk, which is how orbax's top-level tree points into each
process's database.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import uuid as _uuid
from typing import BinaryIO, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
EMPTY = 2**64 - 1

# what orbax's StandardCheckpointer asks of tensorstore (orbax-checkpoint 0.11.32)
ORBAX_CONFIG = dict(max_inline_value_bytes=1024, max_decoded_node_bytes=100_000_000, version_tree_arity_log2=4)


class OcdbtError(ValueError):
    """A malformed, truncated or corrupt OCDBT file."""


@dataclasses.dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int = 0
    max_inline_value_bytes: int = ORBAX_CONFIG["max_inline_value_bytes"]
    max_decoded_node_bytes: int = ORBAX_CONFIG["max_decoded_node_bytes"]
    version_tree_arity_log2: int = ORBAX_CONFIG["version_tree_arity_log2"]
    compression: int = 1  # zstd
    zstd_level: int = 0


@dataclasses.dataclass(frozen=True)
class Ref:
    """``length`` bytes at ``offset`` of the data file ``base + path``."""
    base: str
    path: str
    offset: int
    length: int

    @property
    def file(self) -> str:
        return self.base + self.path


@dataclasses.dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: Optional[Ref]  # None: an empty tree
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time: int


@dataclasses.dataclass(frozen=True)
class VersionNodeRef:
    generation: int
    ref: Ref
    num_generations: int
    commit_time: int
    height: int


@dataclasses.dataclass(frozen=True)
class Manifest:
    config: Config
    versions: Tuple[Version, ...]
    version_nodes: Tuple[VersionNodeRef, ...]


Value = Union[bytes, bytearray, memoryview, Ref, Sequence]  # a Sequence: buffers written one after another


# ---------------------------------------------------------------------------
# encoding primitives


class _In:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = memoryview(buf), 0, what

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise OcdbtError(f"[ocdbt] truncated {self.what}: {n} bytes wanted at {self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OcdbtError(f"[ocdbt] varint over 64 bits in {self.what}")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n))) if n else []

    def end(self) -> None:
        if self.pos != len(self.buf):
            raise OcdbtError(f"[ocdbt] {len(self.buf) - self.pos} bytes left over in {self.what}")


def _varint(n: int) -> bytes:
    if n < 0:
        raise ValueError("[ocdbt] a varint is unsigned")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(ns: Iterable[int]) -> bytes:
    return b"".join(_varint(int(n)) for n in ns)


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _unframe(raw: bytes, magic: int, what: str, max_body: int = 1 << 31) -> bytes:
    """The body of a framed manifest or node; checks magic, length and
    CRC-32C."""
    if len(raw) < 18:
        raise OcdbtError(f"[ocdbt] truncated {what}: {len(raw)} bytes")
    got_magic, length = struct.unpack_from(">I", raw, 0)[0], struct.unpack_from("<Q", raw, 4)[0]
    if got_magic != magic:
        raise OcdbtError(f"[ocdbt] {what} has magic {got_magic:#010x}, {magic:#010x} expected")
    if length != len(raw):
        raise OcdbtError(f"[ocdbt] {what} declares {length} bytes, {len(raw)} read")
    want = struct.unpack_from("<I", raw, len(raw) - 4)[0]
    if zstd.crc32c(memoryview(raw)[:-4]) != want:
        raise OcdbtError(f"[ocdbt] CRC-32C mismatch in {what}")
    head = _In(raw[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OcdbtError(f"[ocdbt] {what} has format version {version}")
    body = bytes(head.buf[head.pos:])
    if compression == 0:
        return body
    if compression != 1:
        raise OcdbtError(f"[ocdbt] {what} has compression format {compression}")
    size = zstd.content_size(body)
    if size is not None:
        if size > max_body:
            raise OcdbtError(f"[ocdbt] {what} decodes to {size} bytes, over {max_body}")
        return bytes(zstd.decompress(body, size))
    cap = 1 << 16
    while True:
        out = bytearray(cap)
        try:
            return bytes(out[:zstd.decompress_into(body, out)])
        except zstd.ZstdError as e:
            if "overruns" not in str(e) or cap >= max_body:
                raise OcdbtError(f"[ocdbt] {what}: {e}") from e
            cap = min(cap * 8, max_body)


def _frame(body: bytes, magic: int) -> bytes:
    """``body`` framed: header, one zstd frame (raw blocks), CRC-32C."""
    payload = b"\x00\x01" + zstd.compress(body)
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4)
    out = head + payload
    return out + struct.pack("<I", zstd.crc32c(out))


# ---------------------------------------------------------------------------
# parts of bodies


def _read_config(r: _In) -> Config:
    uid = bytes(r.take(16))
    kind, inline, node_bytes = r.varint(), r.varint(), r.varint()
    arity = r.u8()
    compression = r.varint()
    level = 0
    if compression == 1:
        level = struct.unpack("<i", r.take(4))[0]
    elif compression != 0:
        raise OcdbtError(f"[ocdbt] unknown compression method {compression} in the config")
    return Config(uid, kind, inline, node_bytes, arity, compression, level)


def _write_config(c: Config) -> bytes:
    out = c.uuid + _varints((c.manifest_kind, c.max_inline_value_bytes, c.max_decoded_node_bytes))
    out += bytes((c.version_tree_arity_log2,)) + _varint(c.compression)
    if c.compression == 1:
        out += struct.pack("<i", c.zstd_level)
    return out


def _read_files(r: _In) -> List[Tuple[str, str]]:
    """The data-file table: ``(base_path, relative_path)`` per file."""
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix, base = r.varints(n), r.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError("[ocdbt] a data-file path shares more than the previous path holds")
        path = prev[:prefix[i]] + bytes(r.take(suffix[i]))
        if base[i] > len(path):
            raise OcdbtError("[ocdbt] a data file's base path is longer than its path")
        out.append((path[:base[i]].decode(), path[base[i]:].decode()))
        prev = path
    return out


def _write_files(files: Sequence[Tuple[str, str]]) -> bytes:
    paths = [(b + p).encode() for b, p in files]
    prefix = [_common(paths[i - 1], paths[i]) for i in range(1, len(paths))]
    suffix = [p[k:] for p, k in zip(paths, [0] + prefix)]
    out = _varint(len(paths)) + _varints(prefix) + _varints(len(s) for s in suffix)
    out += _varints(len(b.encode()) for b, _ in files) + b"".join(suffix)
    return out


def _ref(files: List[Tuple[str, str]], fid: int, offset: int, length: int) -> Optional[Ref]:
    if offset == EMPTY and length == EMPTY:
        return None
    if fid >= len(files):
        raise OcdbtError(f"[ocdbt] data file {fid} of a table of {len(files)}")
    return Ref(*files[fid], offset, length)


def _read_versions(r: _In, files) -> List[Version]:
    n = r.varint()
    gen = r.varints(n)
    height = [r.u8() for _ in range(n)]
    fid, off, ln, keys, tree, ind = (r.varints(n) for _ in range(6))
    times = r.u64s(n)
    return [Version(gen[i], height[i], _ref(files, fid[i], off[i], ln[i]), keys[i], tree[i], ind[i], times[i])
            for i in range(n)]


def _read_version_refs(r: _In, files, height: Optional[int] = None) -> List[VersionNodeRef]:
    """Version-tree node references: in the manifest each carries its
    height; in an interior version node the height is the node's less one."""
    n = r.varint()
    gen, fid, off, ln, count = (r.varints(n) for _ in range(5))
    times = r.u64s(n)
    heights = [r.u8() for _ in range(n)] if height is None else [height] * n
    return [VersionNodeRef(gen[i], _ref(files, fid[i], off[i], ln[i]), count[i], times[i], heights[i])
            for i in range(n)]


def parse_manifest(raw: bytes, what: str = "manifest") -> Manifest:
    r = _In(_unframe(raw, MANIFEST_MAGIC, what), what)
    config = _read_config(r)
    if r.pos == len(r.buf):  # the numbered kind's manifest.ocdbt: the config alone
        return Manifest(config, (), ())
    files = _read_files(r)
    versions = _read_versions(r, files)
    nodes = _read_version_refs(r, files)
    r.end()
    return Manifest(config, tuple(versions), tuple(nodes))


@dataclasses.dataclass(frozen=True)
class Entry:
    """A leaf entry: its full key, and its value inline or by reference."""
    key: bytes
    value: Optional[bytes]
    ref: Optional[Ref]


def parse_btree_node(raw: bytes, prefix: bytes = b"", what: str = "B+tree node",
                     max_body: int = 1 << 31) -> Tuple[int, list]:
    """``(height, entries)`` of a node. A leaf's entries are ``Entry``s; an
    interior node's ``(key, child Ref, common prefix of its subtree,
    num_keys, num_tree_bytes, num_indirect_value_bytes)``. Keys are
    returned whole: ``prefix`` is what the node's ancestors left out."""
    r = _In(_unframe(raw, BTREE_MAGIC, what, max_body), what)
    height = r.u8()
    files = _read_files(r)
    n = r.varint()
    if n == 0:
        raise OcdbtError(f"[ocdbt] {what} has no entries")
    kprefix = [0] + r.varints(n - 1)
    ksuffix = r.varints(n)
    common = r.varints(n) if height else None
    keys, prev = [], b""
    for i in range(n):
        if kprefix[i] > len(prev):
            raise OcdbtError(f"[ocdbt] a key in {what} shares more than the previous key holds")
        prev = prev[:kprefix[i]] + bytes(r.take(ksuffix[i]))
        keys.append(prev)
    if height == 0:
        lengths = r.varints(n)
        kinds = [r.u8() for _ in range(n)]
        if any(k > 1 for k in kinds):
            raise OcdbtError(f"[ocdbt] unknown value kind in {what}")
        indirect = [i for i in range(n) if kinds[i] == 1]
        fid, off = r.varints(len(indirect)), r.varints(len(indirect))
        refs = {i: _ref(files, f, o, lengths[i]) for i, f, o in zip(indirect, fid, off)}
        entries = [Entry(prefix + keys[i], None if kinds[i] else bytes(r.take(lengths[i])), refs.get(i))
                   for i in range(n)]
    else:
        fid, off, ln, nk, nt, ni = (r.varints(n) for _ in range(6))
        entries = []
        for i in range(n):
            if common[i] > len(keys[i]):
                raise OcdbtError(f"[ocdbt] a subtree prefix in {what} is longer than its key")
            child = _ref(files, fid[i], off[i], ln[i])
            if child is None:
                raise OcdbtError(f"[ocdbt] {what} has a child with no location")
            entries.append((prefix + keys[i], child, prefix + keys[i][:common[i]], nk[i], nt[i], ni[i]))
    r.end()
    return height, entries


def parse_version_node(raw: bytes, what: str = "version node"):
    """``(height, entries)``: at height 0 ``Version``s, above it
    ``VersionNodeRef``s of the children."""
    r = _In(_unframe(raw, VERSION_MAGIC, what), what)
    r.u8()  # version_tree_arity_log2
    height = r.u8()
    files = _read_files(r)
    entries = _read_versions(r, files) if height == 0 else _read_version_refs(r, files, height - 1)
    r.end()
    return height, entries


# ---------------------------------------------------------------------------
# reading a database


class Database:
    """A database directory, read at its newest version. Files are read
    with ``os.pread`` through one open descriptor each, so values can be
    read from several threads."""

    def __init__(self, root: str):
        self.root = root
        self.manifest = self._load_manifest()
        self.config = self.manifest.config
        if not self.manifest.versions:
            raise OcdbtError(f"[ocdbt] {root} holds no version")
        self.version = max(self.manifest.versions, key=lambda v: v.generation)
        self._fds: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _load_manifest(self) -> Manifest:
        path = os.path.join(self.root, "manifest.ocdbt")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"[ocdbt] no manifest.ocdbt in {self.root}")
        with open(path, "rb") as f:
            manifest = parse_manifest(f.read(), path)
        if manifest.config.manifest_kind == 1:
            numbered = sorted(n for n in os.listdir(self.root)
                              if n.startswith("manifest.") and len(n) == 25 and n[9:].isalnum())
            if not numbered:
                raise OcdbtError(f"[ocdbt] {self.root} is of the numbered kind and has no numbered manifest")
            with open(os.path.join(self.root, numbered[-1]), "rb") as f:
                inner = parse_manifest(f.read(), numbered[-1])
            manifest = Manifest(manifest.config, inner.versions, inner.version_nodes)
        elif manifest.config.manifest_kind != 0:
            raise OcdbtError(f"[ocdbt] unknown manifest kind {manifest.config.manifest_kind}")
        return manifest

    def close(self) -> None:
        with self._lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_ref(self, ref: Ref) -> bytes:
        """The bytes ``ref`` points at (a value or a node)."""
        with self._lock:
            fd = self._fds.get(ref.file)
            if fd is None:
                fd = self._fds[ref.file] = os.open(os.path.join(self.root, ref.file), os.O_RDONLY)
        out = os.pread(fd, ref.length, ref.offset)
        if len(out) != ref.length:
            raise OcdbtError(f"[ocdbt] {ref.file}: {ref.length} bytes wanted at {ref.offset}, {len(out)} read")
        return out

    def all_versions(self) -> List[Version]:
        """Every version, those in the version tree first (oldest first)."""
        out: List[Version] = []

        def walk(node: VersionNodeRef) -> None:
            height, entries = parse_version_node(self.read_ref(node.ref), f"version node {node.ref.file}")
            for e in entries:
                if height == 0:
                    out.append(e)
                else:
                    walk(e)

        for node in self.manifest.version_nodes:
            walk(node)
        return sorted(out + list(self.manifest.versions), key=lambda v: v.generation)

    def entries(self) -> Iterator[Entry]:
        """Every leaf entry of the version's tree, in key order."""
        if self.version.root is None:
            return

        def walk(ref: Ref, prefix: bytes) -> Iterator[Entry]:
            height, entries = parse_btree_node(self.read_ref(ref), prefix, f"B+tree node in {ref.file}",
                                               self.config.max_decoded_node_bytes)
            for e in entries:
                if height == 0:
                    yield e
                else:
                    yield from walk(e[1], e[2])

        yield from walk(self.version.root, b"")

    def read(self, entry: Entry) -> bytes:
        return entry.value if entry.ref is None else self.read_ref(entry.ref)

    def items(self) -> Dict[bytes, bytes]:
        return {e.key: self.read(e) for e in self.entries()}


# ---------------------------------------------------------------------------
# writing a database


def _leaf_body(entries: Sequence[Tuple[bytes, Union[bytes, Ref]]], prefix: bytes) -> bytes:
    files = sorted({(v.base, v.path) for _, v in entries if isinstance(v, Ref)})
    fid = {f: i for i, f in enumerate(files)}
    keys = [k[len(prefix):] for k, _ in entries]
    kprefix = [_common(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    out = bytes((0,)) + _write_files(files) + _varint(len(keys)) + _varints(kprefix)
    out += _varints(len(k) - p for k, p in zip(keys, [0] + kprefix)) + b"".join(
        k[p:] for k, p in zip(keys, [0] + kprefix))
    values = [v for _, v in entries]
    out += _varints(v.length if isinstance(v, Ref) else len(v) for v in values)
    out += bytes(int(isinstance(v, Ref)) for v in values)
    refs = [v for v in values if isinstance(v, Ref)]
    out += _varints(fid[(v.base, v.path)] for v in refs) + _varints(v.offset for v in refs)
    return out + b"".join(bytes(v) for v in values if not isinstance(v, Ref))


def _interior_body(height: int, children: Sequence[tuple], prefix: bytes) -> bytes:
    """``children``: ``(first key, Ref, num_keys, num_tree_bytes,
    num_indirect_value_bytes)``; every child's keys are written whole below
    ``prefix`` (a subtree prefix of 0)."""
    files = sorted({(c[1].base, c[1].path) for c in children})
    fid = {f: i for i, f in enumerate(files)}
    keys = [c[0][len(prefix):] for c in children]
    kprefix = [_common(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    out = bytes((height,)) + _write_files(files) + _varint(len(keys)) + _varints(kprefix)
    out += _varints(len(k) - p for k, p in zip(keys, [0] + kprefix)) + _varints(0 for _ in keys)
    out += b"".join(k[p:] for k, p in zip(keys, [0] + kprefix))
    out += _varints(fid[(c[1].base, c[1].path)] for c in children) + _varints(c[1].offset for c in children)
    out += _varints(c[1].length for c in children)
    for j in (2, 3, 4):
        out += _varints(c[j] for c in children)
    return out


def _groups(sizes: Sequence[int], limit: int) -> List[Tuple[int, int]]:
    """Consecutive ``[start, end)`` runs whose sizes add up to at most
    ``limit`` (at least one item each)."""
    out, start, total = [], 0, 0
    for i, s in enumerate(sizes):
        if i > start and total + s > limit:
            out.append((start, i))
            start, total = i, 0
        total += s
    if sizes:
        out.append((start, len(sizes)))
    return out


class _DataFile:
    """One data file ``d/<hex>`` being written: values, then nodes."""

    def __init__(self, root: str):
        self.base, self.path = "", f"d/{_uuid.uuid4().hex}"
        os.makedirs(os.path.join(root, "d"), exist_ok=True)
        self.f: BinaryIO = open(os.path.join(root, self.path), "wb")
        self.size = 0

    def append(self, pieces) -> Ref:
        start = self.size
        for p in pieces:
            self.f.write(p)
            self.size += memoryview(p).nbytes
        return Ref(self.base, self.path, start, self.size - start)


def write_database(root: str, items: Iterable[Tuple[bytes, Value]], *, config: Optional[Config] = None) -> None:
    """Write a database of ``items`` (key, value) into the directory
    ``root`` with one version.
    A value is bytes (inline when it is at most ``max_inline_value_bytes``,
    else appended to the data file), a sequence of buffers written one
    after another (one value), or a ``Ref`` to bytes on disk (paths relative
    to ``root``)."""
    config = config or Config(_uuid.uuid4().bytes)
    data: Optional[_DataFile] = None
    entries: List[Tuple[bytes, Union[bytes, Ref]]] = []
    for key, value in items:
        key = bytes(key)
        if not isinstance(value, (bytes, bytearray, memoryview, Ref)):
            pieces = list(value)
            nbytes = sum(memoryview(p).nbytes for p in pieces)
            value = b"".join(bytes(p) for p in pieces) if nbytes <= config.max_inline_value_bytes else pieces
        if isinstance(value, (bytes, bytearray, memoryview)) and len(value) > config.max_inline_value_bytes:
            value = [value]
        if isinstance(value, list):
            data = data or _DataFile(root)
            value = data.append(value)
        entries.append((key, value if isinstance(value, Ref) else bytes(value)))
    entries.sort(key=lambda e: e[0])
    if any(entries[i][0] == entries[i + 1][0] for i in range(len(entries) - 1)):
        raise ValueError("[ocdbt] duplicate keys")
    num_keys = len(entries)
    indirect = sum(v.length for _, v in entries if isinstance(v, Ref))
    root_ref, height, tree_bytes = None, 0, 0
    if entries:
        data = data or _DataFile(root)
        limit = config.max_decoded_node_bytes
        sizes = [len(k) + (16 if isinstance(v, Ref) else len(v)) + 8 for k, v in entries]
        level = []  # (first key, Ref, num_keys, num_tree_bytes, num_indirect_value_bytes)
        for s, e in _groups(sizes, limit - 256):
            part = entries[s:e]
            ref = data.append([_frame(_leaf_body(part, b""), BTREE_MAGIC)])
            level.append((part[0][0], ref, len(part), ref.length,
                          sum(v.length for _, v in part if isinstance(v, Ref))))
        while len(level) > 1:
            height += 1
            up = []
            for s, e in _groups([len(c[0]) + 40 for c in level], limit - 256):
                part = level[s:e]
                ref = data.append([_frame(_interior_body(height, part, b""), BTREE_MAGIC)])
                up.append((part[0][0], ref, sum(c[2] for c in part), ref.length + sum(c[3] for c in part),
                           sum(c[4] for c in part)))
            level = up
        root_ref, tree_bytes = level[0][1], level[0][3]
    if data is not None:
        data.f.close()
    files = [(root_ref.base, root_ref.path)] if root_ref else [("", "")]
    off, ln = (root_ref.offset, root_ref.length) if root_ref else (EMPTY, EMPTY)
    body = _write_config(dataclasses.replace(config, manifest_kind=0)) + _write_files(files)
    body += _varint(1) + _varint(1) + bytes((height,)) + _varints(  # one version, generation 1
        (0, off, ln, num_keys, tree_bytes, indirect)) + struct.pack("<Q", time.time_ns()) + _varint(0)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(_frame(body, MANIFEST_MAGIC))


def entries_as_refs(root: str, base: str) -> List[Tuple[bytes, Union[bytes, Ref]]]:
    """The entries of the database at ``root/base``, their references
    rebased onto ``root`` (for a tree over several databases, as orbax's
    top level is over its processes')."""
    with Database(os.path.join(root, base)) as db:
        return [(e.key, e.value if e.ref is None else dataclasses.replace(e.ref, base=base + e.ref.base))
                for e in db.entries()]


__all__ = ["Config", "Database", "Entry", "Manifest", "OcdbtError", "ORBAX_CONFIG", "Ref", "Version",
           "entries_as_refs", "parse_btree_node", "parse_manifest", "parse_version_node", "write_database"]
