"""Min-plus line transform ``g[r, i] = min_j f[r, j] + cost[j, i]``.

The port of ``multimodal_tta_tpu/pallas/edt_minplus.py`` (``minplus_pallas``):
one separable pass of the exact squared euclidean distance transform
(``ops/surface.py``), which carries HD95/ASD/NSD in evaluation.

* ``minplus`` — the wrapper. A CUDA tensor launches the hand-written kernel
  of ``csrc/edt_minplus.cu`` (built by ``nvcc`` at first use, ``_build.py``)
  or raises; a CPU tensor takes the plain version. There is no other route
  and no fallback from a failed build or launch. ``minplus.launches``
  counts kernel launches.
* ``minplus_plain`` — the plain PyTorch version of the same function (a
  chunked broadcast add and min over j): what the CPU tests run, and what
  the kernel is held against on the card — bitwise, since each candidate is
  one f32 add and a min is exact in any order.

On the card the function is bound by the f32 instruction rate
(``2 * rows * n^2`` adds and mins against ``4 * (2 * rows * n + n^2)``
bytes); the kernel keeps 4 x 4 outputs per thread in registers and stages
``f`` and ``cost`` tiles in shared memory (see the note in the source).
"""

from __future__ import annotations

import ctypes

import torch

_PLAIN_CHUNK = 256  # rows per [chunk, n, n] broadcast temporary


def _check(f: torch.Tensor, cost: torch.Tensor) -> None:
    if f.dim() != 2 or f.shape[0] <= 0 or f.shape[1] <= 0:
        raise ValueError(f"minplus: f must be a non-empty [rows, n] tensor, got {tuple(f.shape)}")
    n = f.shape[1]
    if tuple(cost.shape) != (n, n):
        raise ValueError(f"minplus: cost must be [{n}, {n}], got {tuple(cost.shape)}")
    if f.dtype != torch.float32 or cost.dtype != torch.float32:
        raise TypeError(f"minplus: f and cost must be float32, got {f.dtype} and {cost.dtype}")
    if cost.device != f.device:
        raise ValueError(f"minplus: f is on {f.device} but cost on {cost.device}")
    if not f.is_contiguous() or not cost.is_contiguous():
        raise ValueError("minplus: f and cost must be contiguous")


def minplus_plain(f: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``minplus``, on any device: rows go through
    in chunks of 256 to bound the ``[chunk, n, n]`` temporaries."""
    _check(f, cost)
    out = torch.empty_like(f)
    for r0 in range(0, f.shape[0], _PLAIN_CHUNK):
        fb = f[r0:r0 + _PLAIN_CHUNK]
        out[r0:r0 + _PLAIN_CHUNK] = (fb[:, :, None] + cost[None, :, :]).amin(dim=1)
    return out


def _library():
    from . import _build

    built = _build.load("edt_minplus")
    fn = built.lib.mtta_minplus_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built.lib.mtta_cuda_error_string.argtypes = [ctypes.c_int]
        built.lib.mtta_cuda_error_string.restype = ctypes.c_char_p
    return built.lib


def _launch_kernel(f: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    rows, n = f.shape
    if n >= 2**31:
        raise ValueError("minplus: a line must hold fewer than 2**31 samples")
    lib = _library()
    g = torch.empty_like(f)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mtta_minplus_f32(f.data_ptr(), cost.data_ptr(), g.data_ptr(),
                                    rows, n, f.stride(0), cost.stride(0), g.stride(0), stream)
    if code != 0:
        text = lib.mtta_cuda_error_string(code).decode()
        raise RuntimeError(f"minplus: kernel launch refused for f {tuple(f.shape)}: "
                           f"CUDA error {code} ({text})")
    minplus.launches += 1
    return g


def minplus(f: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """f: [rows, n] f32 with values in [0, +inf]; cost: [n, n] f32, finite.
    Returns g [rows, n] f32 with ``g[r, i] = min_j f[r, j] + cost[j, i]``;
    an all-inf row stays all inf. Launches on the current stream and does
    not synchronise."""
    _check(f, cost)
    if f.device.type == "cuda":
        return _launch_kernel(f, cost)
    if f.device.type == "cpu":
        return minplus_plain(f, cost)
    raise ValueError(f"minplus: no kernel for device {f.device}")


minplus.launches = 0
