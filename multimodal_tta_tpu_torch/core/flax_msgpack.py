"""flax's msgpack format, read and written without the ``msgpack`` package
(the port of ``flax.serialization.msgpack_serialize`` / ``msgpack_restore``,
which the reference's ``save_checkpoint`` writes through ``to_bytes``).

The subset flax writes: nil, bool, the int and float families, str, bin,
array and map, plus three ext types:

  * ext 1, an ndarray: the msgpack array ``(shape, dtype name, C-order
    bytes)``. Arrays come and go here as ``torch.Tensor``s; a read one is a
    view over the buffer (``torch.frombuffer``), and ``bfloat16`` (no numpy
    dtype) is read as its ``uint16`` bits viewed as ``torch.bfloat16``. A
    numpy array is written as one too.
  * ext 3, a numpy scalar, packed as a 0-d ndarray (read as the numpy
    scalar, written from one).
  * ext 2, a Python complex ``(real, imag)``: read only.

An array over ``MAX_CHUNK_SIZE`` bytes is written, and read, as flax's
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}`` of
flat pieces.

Key order is flax's: the reference's payload passes through
``jax.device_get``, which sorts the keys of every plain dict, and
``to_state_dict`` then turns a NamedTuple into a map in field order and a
tuple into ``{"0": ..., "1": ...}`` in index order. ``packb`` writes a plain
dict sorted and a ``Fields`` (a dict) in insertion order, so a tree built
from ``Fields`` for the optax states and plain dicts for the param trees
comes out byte for byte as flax writes it. ``unpackb`` returns plain dicts
in file order.

``packb`` streams to a file object: each leaf's header, then its bytes
straight from the host copy of the tensor, so no second copy of the whole
blob is built.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict, Union

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax's limit per array leaf (msgpack's own is 2**31 - 1)

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16, "int8": torch.int8,
    "uint64": torch.uint64, "uint32": torch.uint32, "uint16": torch.uint16, "uint8": torch.uint8,
    "bool": torch.bool, "complex64": torch.complex64, "complex128": torch.complex128,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class Fields(dict):
    """A map written in insertion order: a NamedTuple's fields, or a tuple's
    ``"0"``, ``"1"``, ... (a plain dict is written with sorted keys)."""


class TupleFields(Fields):
    """A tuple's ``Fields``: written alike here; the orbax format
    (``core/orbax_format.py``) records its keys as tuple indices and an
    empty one as ``()``."""


# ---------------------------------------------------------------------------
# writing


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0 <= n <= 0xFF:
        return b"\xcc" + struct.pack("B", n)
    if -0x80 <= n < 0:
        return b"\xd0" + struct.pack("b", n)
    if 0 <= n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if -0x8000 <= n < 0:
        return b"\xd1" + struct.pack(">h", n)
    if 0 <= n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    if -0x80000000 <= n < 0:
        return b"\xd2" + struct.pack(">i", n)
    if 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", n)
    if -0x8000000000000000 <= n < 0:
        return b"\xd3" + struct.pack(">q", n)
    raise OverflowError(f"[msgpack] integer {n} does not fit 64 bits")


def _sized(n: int, fix: int, fix_max: int, codes: bytes, widths=(1, 2, 4)) -> bytes:
    """The header of a str / bin / array / map of ``n`` items: a fix form
    below ``fix_max`` (``fix`` None: none), else the first of ``codes``
    whose width holds ``n``."""
    if fix is not None and n < fix_max:
        return bytes((fix | n,))
    for code, width in zip(codes, widths):
        if n < 1 << (8 * width):
            return bytes((code,)) + n.to_bytes(width, "big")
    raise OverflowError(f"[msgpack] {n} items or bytes is over the format's limit")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 32, b"\xd9\xda\xdb") + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, b"\xc4\xc5\xc6")


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 16, b"\xdc\xdd", (2, 4))


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 16, b"\xde\xdf", (2, 4))


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes((fixed[n],)) if n in fixed else _sized(n, None, 0, b"\xc7\xc8\xc9")
    return head + struct.pack("b", code)


def _host_bytes(x) -> tuple:
    """``(shape, dtype name, a uint8 view of the C-order bytes)`` of a
    tensor (copied to the host when it is on a device) or an ndarray."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype not in _NAMES:
            raise TypeError(f"[msgpack] no flax dtype name for {t.dtype}")
        t = t.cpu().contiguous()
        return tuple(t.shape), _NAMES[t.dtype], t.reshape(-1).view(torch.uint8).numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("[msgpack] object and structured dtypes are not supported")
    return x.shape, x.dtype.name, np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _write_array(fp: BinaryIO, shape, name: str, data: np.ndarray, code: int) -> int:
    """One ndarray ext: the header, then the bytes from ``data`` itself."""
    inner = _array_header(3) + _array_header(len(shape)) + b"".join(_int(int(d)) for d in shape) + _str(name)
    inner += _bin_header(data.nbytes)
    head = _ext_header(len(inner) + data.nbytes, code) + inner
    fp.write(head)
    if data.nbytes:
        fp.write(memoryview(data))
    return len(head) + data.nbytes


def _chunked(x) -> Fields:
    """flax's ``_chunk``: the flat array in pieces of ``MAX_CHUNK_SIZE``
    bytes, in insertion order (the form is made after ``device_get``)."""
    flat = x.reshape(-1)
    itemsize = flat.element_size() if isinstance(flat, torch.Tensor) else flat.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return Fields([(_CHUNKED, True), ("shape", Fields((str(i), int(d)) for i, d in enumerate(x.shape))),
                   ("chunks", Fields((str(i), c) for i, c in enumerate(chunks)))])


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _pack(x, fp: BinaryIO) -> int:
    if isinstance(x, (torch.Tensor, np.ndarray)):
        if _nbytes(x) > MAX_CHUNK_SIZE:
            return _pack(_chunked(x), fp)
        return _write_array(fp, *_host_bytes(x), _EXT_NDARRAY)
    if isinstance(x, np.generic):
        return _write_array(fp, *_host_bytes(np.asarray(x)), _EXT_NPSCALAR)
    if isinstance(x, dict):
        items = list(x.items()) if isinstance(x, Fields) else sorted(x.items(), key=lambda kv: kv[0])
        head = _map_header(len(items))
        fp.write(head)
        n = len(head)
        for k, v in items:
            n += _pack(k, fp) + _pack(v, fp)
        return n
    if isinstance(x, (list, tuple)):
        head = _array_header(len(x))
        fp.write(head)
        return len(head) + sum(_pack(v, fp) for v in x)
    if x is None:
        b = b"\xc0"
    elif isinstance(x, bool):
        b = b"\xc3" if x else b"\xc2"
    elif isinstance(x, int):
        b = _int(x)
    elif isinstance(x, float):
        b = b"\xcb" + struct.pack(">d", x)
    elif isinstance(x, str):
        b = _str(x)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = _bin_header(len(x)) + bytes(x)
    else:
        raise TypeError(f"[msgpack] cannot write a {type(x).__name__}")
    fp.write(b)
    return len(b)


def packb(tree, fp: BinaryIO) -> int:
    """Write ``tree`` to ``fp`` as ``flax.serialization.msgpack_serialize``
    writes it (an array leaf over ``MAX_CHUNK_SIZE`` bytes in pieces);
    returns the bytes written."""
    return _pack(tree, fp)


# ---------------------------------------------------------------------------
# reading


class _Reader:
    def __init__(self, buf):
        self.buf = buf if isinstance(buf, memoryview) else memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"[msgpack] truncated: {n} bytes wanted at offset {self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        out = struct.unpack_from(fmt, self.buf, self.pos)[0]
        self.pos += struct.calcsize(fmt)
        return out

    def read(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sizes:
            return str(self.take(self.unpack(sizes[b])), "utf-8")
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sizes:
            return bytes(self.take(self.unpack(sizes[b])))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixed:
            return self.ext(fixed[b])
        sizes = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sizes:
            return self.ext(self.unpack(sizes[b]))
        raise ValueError(f"[msgpack] unknown format byte 0x{b:02x} at offset {self.pos - 1}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if out.get(_CHUNKED) is True:
            return _unchunk(out)
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        end = self.pos + n
        if code == _EXT_COMPLEX:
            re_, im = self.read()
            out = complex(re_, im)
        elif code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            out = self.ndarray(code == _EXT_NPSCALAR)
        else:
            raise ValueError(f"[msgpack] ext type {code} is not flax's")
        if self.pos != end:
            raise ValueError(f"[msgpack] ext type {code} of {n} bytes read as {self.pos - (end - n)}")
        return out

    def ndarray(self, scalar: bool):
        if self.unpack("B") != 0x93:
            raise ValueError(f"[msgpack] an ndarray ext is not a 3-array at offset {self.pos - 1}")
        shape, name = self.read(), self.read()
        name = name.decode() if isinstance(name, bytes) else name
        b = self.unpack("B")
        if b not in (0xC4, 0xC5, 0xC6):
            raise ValueError(f"[msgpack] an ndarray's bytes are not a bin at offset {self.pos - 1}")
        n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        start = self.pos
        self.take(n)
        if scalar and name != "bfloat16":
            return np.frombuffer(self.buf[start:start + n], dtype=np.dtype(name))[0]
        dtype = _DTYPES.get(name)
        if dtype is None:
            raise ValueError(f"[msgpack] unknown dtype name {name!r}")
        read_as = torch.uint16 if dtype is torch.bfloat16 else dtype
        count = int(np.prod(shape, dtype=np.int64))
        if count == 0:
            t = torch.empty(shape, dtype=dtype)
        else:
            t = torch.frombuffer(self.buf, dtype=read_as, count=count, offset=start).view(dtype).reshape(shape)
        if count * t.element_size() != n:
            raise ValueError(f"[msgpack] {n} bytes for {name} {shape}")
        return t[()] if scalar else t


def _unchunk(d: dict) -> torch.Tensor:
    """flax's ``_unchunk``: the pieces joined and shaped."""
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return torch.cat(chunks).reshape(shape)


def unpackb(buf: Union[bytes, bytearray, memoryview]) -> Any:
    """The tree of ``buf`` (flax's ``msgpack_restore``): maps as dicts,
    arrays as tensors over ``buf`` (pass a writable buffer, as ``load``
    does, for tensors that may be written), chunked arrays joined."""
    r = _Reader(buf)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"[msgpack] {len(r.buf) - r.pos} bytes after the tree")
    return out


def load(path: str) -> Dict[str, Any]:
    """``unpackb`` of the file at ``path``, read once into a writable buffer
    that the returned tensors share."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        f.seek(0)
        buf = bytearray(size)
        if f.readinto(buf) != size:
            raise ValueError(f"[msgpack] {path}: short read")
    return unpackb(buf)


def dump(tree, path: str) -> int:
    """``packb`` of ``tree`` into the file at ``path``; returns the bytes."""
    with open(path, "wb") as f:
        return packb(tree, f)


__all__ = ["MAX_CHUNK_SIZE", "Fields", "TupleFields", "dump", "load", "packb", "unpackb"]
