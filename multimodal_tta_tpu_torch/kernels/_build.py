"""Build and load the port's CUDA C++ kernels.

Each source ``csrc/<name>.cu`` has a plain ``extern "C"`` interface (device
pointers, sizes, strides, the stream) and includes nothing of PyTorch, so
``nvcc`` compiles it in seconds into a shared library of its own:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>_<hash>.so csrc/<name>.cu

The library is built at first use into ``build/kernels/`` beside the package
(listed in .gitignore), named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused. It is loaded with
``ctypes``; the wrapper that calls it sets ``argtypes``. A missing compiler
or a failed build raises: nothing falls back.

No ``--use_fast_math``: the EDT kernel's inputs hold ``+inf`` on purpose.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from typing import Dict

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_BUILD_TIMEOUT_S = 600


@dataclass
class Built:
    """One loaded kernel library and how it came to be."""

    lib: ctypes.CDLL
    path: str
    seconds: float  # 0.0 when an earlier build was reused
    log: str  # nvcc's output (ptxas -v: registers, shared memory, spills)


_loaded: Dict[str, Built] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's usual place. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "multimodal_tta_tpu_torch: nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def nvcc_release() -> str:
    """The ``release`` line of ``nvcc --version``."""
    out = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
    return lines[0] if lines else out.strip()


def load(name: str) -> Built:
    """Build ``csrc/<name>.cu`` if its library is not there yet, load it and
    return it. One library per process and source; later calls return the
    same object."""
    if name in _loaded:
        return _loaded[name]
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    seconds, log = 0.0, ""
    if not os.path.isfile(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        log = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0 or not os.path.isfile(tmp):
            if os.path.isfile(tmp):
                os.remove(tmp)
            raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    built = Built(lib=ctypes.CDLL(path), path=path, seconds=seconds, log=log)
    _loaded[name] = built
    return built
