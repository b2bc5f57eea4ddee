"""ctypes binding of the host NIfTI decode core ``csrc/nifti_native.cpp``
(the port of ``multimodal_tta_tpu/data/_native.py``).

The shared library is built with ``g++`` at first use:

    g++ -O3 -shared -fPIC -std=c++17 csrc/nifti_native.cpp -o build/native/libnifti_native_<hash>.so -lz

into ``build/native/`` at the repository root (listed in .gitignore), named
by a hash of the source and the flags, so an edited source is rebuilt. Every
entry point has a pure-Python fallback in ``data/nifti.py``: without a
compiler or zlib the port still reads NIfTI, only slower, and
``nifti.decode_counts`` shows which path ran (``build_log()`` says why the
library is missing). The native path is a throughput optimization of the
input pipeline: ctypes calls drop the GIL, so the threaded host loader's
decodes run in parallel. This is host code; nothing here touches the GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "csrc", "nifti_native.cpp")
_BUILD_DIR = os.path.join(_REPO, "build", "native")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_build_log = ""


def _build() -> Optional[str]:
    """Compile the core into ``build/native/``; its path, or None (the
    compiler's output is kept for ``build_log()``)."""
    global _build_log
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"libnifti_native_{digest}.so")
    if os.path.isfile(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp, "-lz"],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        _build_log = f"g++ did not run: {e}"
        return None
    _build_log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0 or not os.path.isfile(tmp):
        if os.path.isfile(tmp):
            os.remove(tmp)
        _build_log = f"g++ exit {proc.returncode}: {_build_log}"
        return None
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            _build_log = f"loading {path} failed: {e}"
            return None
        lib.nn_gunzip.restype = ctypes.c_longlong
        lib.nn_gunzip.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
        lib.nn_cast_reorient_f32.restype = ctypes.c_int
        lib.nn_cast_reorient_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def build_log() -> str:
    """What the compiler (or the loader) said when the library was made; ""
    when an earlier build was reused or nothing was tried yet."""
    return _build_log


def gunzip(data: bytes, expected_size: int) -> Optional[bytes]:
    """Inflate a gzip byte string with the native zlib core; None when the
    core is not usable (the caller falls back to the stdlib gzip path).
    ctypes releases the GIL for the whole inflate."""
    lib = get_lib()
    if lib is None:
        return None
    cap = max(int(expected_size), 1024)
    for _ in range(10):  # grow if the caller's size hint was low
        out = ctypes.create_string_buffer(cap)
        n = lib.nn_gunzip(data, len(data), out, cap)
        if n >= 0:
            return out.raw[:n]
        if n == -2:
            cap *= 4
            continue
        return None
    return None


def cast_reorient_f32(raw: bytes, dtype_code: int, shape_xyz, flips, slope: float,
                      inter: float) -> Optional[np.ndarray]:
    """raw Fortran (X,Y,Z) voxels -> C-ordered float32 (Z,Y,X) array with
    per-axis flips (input index space) and intensity scaling fused in."""
    lib = get_lib()
    if lib is None:
        return None
    nx, ny, nz = (int(s) for s in shape_xyz)
    itemsize = {2: 1, 4: 2, 8: 4, 16: 4, 64: 8, 256: 1, 512: 2, 768: 4}.get(int(dtype_code))
    if itemsize is None or len(raw) < nx * ny * nz * itemsize:
        return None  # the C core would read past the buffer
    out = np.empty((nz, ny, nx), dtype=np.float32)
    rc = lib.nn_cast_reorient_f32(
        raw, int(dtype_code), nx, ny, nz,
        int(bool(flips[0])), int(bool(flips[1])), int(bool(flips[2])),
        float(slope), float(inter), out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        return None
    return out
