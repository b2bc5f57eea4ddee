"""zstd frames, read natively and written plainly, and CRC-32C: the codec
under the reference's orbax checkpoints (``core/ocdbt.py``,
``core/orbax_format.py``).

Reading: ``csrc/zstd_decode.cpp``, a whole-frame zstd decoder (RFC 8878),
bound with ``ctypes``. The shared library is built with ``g++`` at first use:

    g++ -O3 -shared -fPIC -std=c++17 multimodal_tta_tpu_torch/csrc/zstd_decode.cpp \
        -o build/native/libzstd_decode_<hash>.so

into ``build/native/`` at the repository root (listed in .gitignore), named
by a hash of the source and the flags, so an edited source is rebuilt. It
links no libzstd. There is no Python fallback: when the library cannot be
built, ``decompress`` raises with the compiler's output. ctypes drops the
GIL for a call, so chunks decode in parallel on a thread pool.

Writing: ``compress`` makes a valid frame of raw blocks (at most 128 KiB
each) and RLE blocks (a block of one repeated byte), with the content size
in its header. Any zstd decoder, tensorstore's among them, reads it; it is
as large as its content, where the reference's level-1 frames compress.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Optional, Union

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
_SRC = os.path.join(_PKG, "csrc", "zstd_decode.cpp")
_BUILD_DIR = os.path.join(_REPO, "build", "native")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

MAGIC = b"\x28\xb5\x2f\xfd"
BLOCK_MAX = 128 << 10

# the decoder's counters, in the order of csrc/zstd_decode.cpp's enum Counter
COUNTERS = ("frames", "skippable_frames", "checksums",
            "blocks_raw", "blocks_rle", "blocks_compressed",
            "literals_raw", "literals_rle", "literals_huffman_1stream", "literals_huffman_4streams",
            "literals_treeless", "weights_direct", "weights_fse",
            "sequences_none", "sequences_predefined", "sequences_rle", "sequences_fse", "sequences_repeat")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

Buffer = Union[bytes, bytearray, memoryview, np.ndarray]


class ZstdError(ValueError):
    """A corrupt or truncated frame, or one that overruns its output."""


def _build() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"libzstd_decode_{digest}.so")
    if os.path.isfile(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"[zstd] g++ did not run, so the native zstd decoder is missing: {e}") from e
    if proc.returncode != 0 or not os.path.isfile(tmp):
        if os.path.isfile(tmp):
            os.remove(tmp)
        raise RuntimeError(f"[zstd] g++ exit {proc.returncode} building {_SRC}:\n{(proc.stdout + proc.stderr).strip()}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path


def lib() -> ctypes.CDLL:
    """The decoder's library, built on first use; raises with the
    compiler's output when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(_build())
            so.zd_decompress.restype = ctypes.c_longlong
            so.zd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
            so.zd_content_size.restype = ctypes.c_longlong
            so.zd_content_size.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
            so.zd_last_error.restype = ctypes.c_char_p
            so.zd_last_error.argtypes = []
            so.zd_counter_count.restype = ctypes.c_int
            so.zd_counter_count.argtypes = []
            so.zd_counters.restype = None
            so.zd_counters.argtypes = [ctypes.c_void_p]
            so.zd_reset_counters.restype = None
            so.zd_reset_counters.argtypes = []
            so.zd_crc32c.restype = ctypes.c_uint
            so.zd_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint]
            if so.zd_counter_count() != len(COUNTERS):
                raise RuntimeError("[zstd] the library's counters do not match COUNTERS")
            _lib = so
    return _lib


def _address(buf: Buffer, writable: bool = False):
    """``(address, nbytes, keep-alive)`` of a contiguous buffer."""
    if isinstance(buf, np.ndarray):
        if not buf.flags.c_contiguous:
            raise ValueError("[zstd] the buffer must be C-contiguous")
        if writable and not buf.flags.writeable:
            raise ValueError("[zstd] the output buffer is read-only")
        return buf.ctypes.data, buf.nbytes, buf
    if isinstance(buf, bytes):
        if writable:
            raise ValueError("[zstd] the output buffer is read-only")
        return ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value, len(buf), buf
    arr = np.frombuffer(buf, dtype=np.uint8)
    if writable and not arr.flags.writeable:
        raise ValueError("[zstd] the output buffer is read-only")
    return arr.ctypes.data, arr.nbytes, arr


def content_size(frame: Buffer) -> Optional[int]:
    """The content size the first frame's header declares, or None."""
    addr, n, keep = _address(frame)
    out = lib().zd_content_size(addr, n)
    if out == -2:
        raise ZstdError("[zstd] not a zstd frame")
    del keep
    return None if out < 0 else int(out)


def decompress_into(frame: Buffer, out: Buffer) -> int:
    """Decode every frame of ``frame`` into ``out`` (a writable buffer);
    returns the bytes written. Raises ``ZstdError`` for a corrupt or
    truncated frame or one that does not fit ``out``."""
    so = lib()
    src, n, keep_src = _address(frame)
    dst, cap, keep_dst = _address(out, writable=True)
    got = so.zd_decompress(src, n, dst, cap)
    del keep_src, keep_dst
    if got < 0:
        raise ZstdError(f"[zstd] {so.zd_last_error().decode(errors='replace')}")
    return int(got)


def decompress(frame: Buffer, size: Optional[int] = None) -> bytearray:
    """The content of ``frame``: exactly ``size`` bytes when given (the
    zarr chunk's size), else the size its header declares. Raises when the
    frame regenerates another size."""
    if size is None:
        size = content_size(frame)
        if size is None:
            raise ZstdError("[zstd] the frame declares no content size; pass size=")
    out = bytearray(size)
    got = decompress_into(frame, out) if size else decompress_into(frame, bytearray(1))
    if got != size:
        raise ZstdError(f"[zstd] the frame regenerates {got} bytes, {size} expected")
    return out


def frame_header(size: int) -> bytes:
    """A frame's magic and header for ``size`` bytes of content: single
    segment, the content size in the smallest field that holds it, no
    checksum."""
    if size < 256:
        return MAGIC + bytes((0x20, size))
    if size < 65536 + 256:
        return MAGIC + bytes((0x60,)) + (size - 256).to_bytes(2, "little")
    if size < 1 << 32:
        return MAGIC + bytes((0xA0,)) + size.to_bytes(4, "little")
    return MAGIC + bytes((0xE0,)) + size.to_bytes(8, "little")


def frame_pieces(data: Buffer) -> List[Union[bytes, memoryview]]:
    """The frame of ``data`` as pieces to write one after another: the
    header, then per block of at most 128 KiB its 3-byte header and either
    the block's bytes (a view into ``data``, not a copy) or, for a block of
    one repeated byte, that byte."""
    view = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data.reshape(-1).view(np.uint8)
    n = view.nbytes
    pieces: List[Union[bytes, memoryview]] = [frame_header(n)]
    if n == 0:
        pieces.append(b"\x01\x00\x00")  # one empty last raw block
        return pieces
    starts = range(0, n, BLOCK_MAX)
    # a block is RLE when all its bytes equal its first
    full = n // BLOCK_MAX * BLOCK_MAX
    rle = np.zeros(len(starts), dtype=bool)
    if full:
        blocks = view[:full].reshape(-1, BLOCK_MAX)
        rle[:full // BLOCK_MAX] = (blocks == blocks[:, :1]).all(axis=1)
    if full < n:
        tail = view[full:]
        rle[-1] = bool((tail == tail[0]).all())
    mv = memoryview(view)
    for i, s in enumerate(starts):
        e = min(s + BLOCK_MAX, n)
        last = int(e == n)
        if rle[i]:
            pieces.append(((e - s) << 3 | 1 << 1 | last).to_bytes(3, "little") + bytes((int(view[s]),)))
        else:
            pieces.append(((e - s) << 3 | last).to_bytes(3, "little"))
            pieces.append(mv[s:e])
    return pieces


def compress(data: Buffer) -> bytes:
    """``data`` as one zstd frame of raw and RLE blocks (``frame_pieces``)."""
    return b"".join(bytes(p) for p in frame_pieces(data))


def crc32c(data: Buffer, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    addr, n, keep = _address(data)
    out = lib().zd_crc32c(addr, n, crc)
    del keep
    return int(out)


def counters() -> Dict[str, int]:
    """How many of each frame, block, literals and sequence mode the
    decoder has met since the last ``reset_counters``."""
    out = (ctypes.c_longlong * len(COUNTERS))()
    lib().zd_counters(out)
    return dict(zip(COUNTERS, (int(v) for v in out)))


def reset_counters() -> None:
    lib().zd_reset_counters()


__all__ = ["BLOCK_MAX", "COUNTERS", "ZstdError", "compress", "content_size", "counters", "crc32c",
           "decompress", "decompress_into", "frame_header", "frame_pieces", "lib", "reset_counters"]
