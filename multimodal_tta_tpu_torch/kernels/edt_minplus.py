"""Min-plus line transforms ``g[r, i] = min_j f[r, j] + cost[j, i]`` and the
squared euclidean distance transform built from them.

The port of ``multimodal_tta_tpu/pallas/edt_minplus.py`` (``minplus_pallas``):
one separable pass of the exact squared EDT (``ops/surface.py``), which
carries HD95/ASD/NSD in evaluation. Two entry points share the inner loop of
``csrc/edt_minplus.cu`` (built by ``nvcc`` at first use, ``_build.py``):

* ``squared_edt_volumes(points [V,D,H,W], spacing, sqrt=False)`` — the whole
  transform of V volumes in ONE launch: a persistent cooperative grid runs
  the passes along D, H and W (the reference's order, which fixes the
  rounding) with a grid barrier between them. Lines are read where they lie
  (no ``movedim().contiguous()`` copy), the cost ``((i - j) * spacing)^2`` is
  a table of n floats built in shared memory (no ``[n, n]`` matrix), the
  first pass reads the byte mask itself and the last may write the root.
* ``minplus(f, cost)`` — the TPU kernel's function with an arbitrary finite
  cost matrix, one launch.

Both entries are registered torch operators (``mtta::minplus``,
``mtta::squared_edt_volumes``, with fake implementations and no gradient). A
CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``squared_edt_volumes_plain``, ``minplus_plain``). There is no other
route and no fallback from a failed build, a refused launch or a grid that is
not co-resident. ``minplus.launches`` counts the kernel launches of both
entries. The kernels are held against the plain versions bitwise: each
candidate is one f32 add and a min is exact in any order.

``plan`` picks, for one pass, the rows of a tile (a warp covers 32 rows x 48
columns), the block's warps, the shared memory and the tile count; it is pure
Python so that CPU tests can pin it.
On the card the function is bound by the f32 instruction rate
(``2 * rows * n^2`` adds and mins against ``8 * rows * n`` bytes); see the
note in the source for what the design does about that.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

_PLAIN_CHUNK = 256  # rows per [chunk, n, n] broadcast temporary
_INF = float("inf")

# geometry of the kernel (csrc/edt_minplus.cu)
THREAD_ROWS = 8  # output rows per thread
THREAD_COLS = 6  # output columns per thread
TILE_PAD = 4  # a tile row is R + 4 floats: transposed stores hit 32 banks
WARP_ROWS = 4 * THREAD_ROWS  # a warp is 4 lanes along the rows: a tile is a multiple of 32 rows
WARP_COLS = 8 * THREAD_COLS  # and 8 lanes along the columns: 48 at once
MAX_WARPS = 16  # 512 threads: 128 registers a thread
MAX_SMEM_OPTIN = 227 * 1024  # what one block may opt in to on an H100
_COST_CODE = {"table": 0, "matrix": 1}
_KIND_CODE = {"strided": 0, "contiguous": 1}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


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


def _check_volumes(points: torch.Tensor, spacing: Sequence[float]) -> Tuple[float, float, float]:
    if points.dim() != 4 or min(points.shape) <= 0:
        raise ValueError("squared_edt_volumes: points must be a non-empty [V, D, H, W] tensor, "
                         f"got {tuple(points.shape)}")
    if not points.is_contiguous():
        raise ValueError("squared_edt_volumes: points must be contiguous")
    if len(spacing) != 3 or not all(0.0 < float(s) < _INF for s in spacing):
        raise ValueError(f"squared_edt_volumes: spacing must be three positive numbers, got {spacing}")
    return float(spacing[0]), float(spacing[1]), float(spacing[2])


# ---- the plain versions -----------------------------------------------------


def minplus_plain(f: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``minplus``, on any device: rows go through
    in chunks of 256 to bound the ``[chunk, n, n]`` temporaries."""
    _check(f, cost)
    out = torch.empty_like(f)
    for r0 in range(0, f.shape[0], _PLAIN_CHUNK):
        fb = f[r0:r0 + _PLAIN_CHUNK]
        out[r0:r0 + _PLAIN_CHUNK] = (fb[:, :, None] + cost[None, :, :]).amin(dim=1)
    return out


def edt_cost_matrix(n: int, spacing: float, device=None) -> torch.Tensor:
    """``cost[j, i] = ((i - j) * spacing) ** 2`` in f32, as the reference
    builds it for one axis."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return ((i[None, :] - i[:, None]) * spacing) ** 2


def edt_cost_table(n: int, spacing: float) -> torch.Tensor:
    """The kernel's cost table ``d2[k] = (k * spacing) * (k * spacing)`` for
    k = 0..n-1 in f32, rounded after each product as the kernel rounds
    (``__fmul_rn``); ``cost[j, i] = d2[|i - j|]``."""
    x = torch.arange(n, dtype=torch.float32) * torch.tensor(spacing, dtype=torch.float32)
    return x * x


def squared_edt_volumes_plain(points: torch.Tensor, spacing: Sequence[float], *,
                              sqrt: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``squared_edt_volumes``, on any device: per
    volume, each axis in turn is moved last, copied contiguous and sent
    through ``minplus_plain`` against the axis' cost matrix."""
    spacing = _check_volumes(points, spacing)
    out = torch.empty(points.shape, dtype=torch.float32, device=points.device)
    for v in range(points.shape[0]):
        f = torch.where(points[v] > 0.5, 0.0, _INF).to(torch.float32)
        for ax in range(3):
            f = f.movedim(ax, -1).contiguous()
            n = f.shape[-1]
            cost = edt_cost_matrix(n, spacing[ax], device=f.device)
            f = minplus_plain(f.reshape(-1, n), cost).reshape(f.shape).movedim(-1, ax)
        out[v] = torch.sqrt(f) if sqrt else f
    return out


# ---- the launch plan --------------------------------------------------------


@dataclass(frozen=True)
class PassPlan:
    """How one pass over ``lines`` lines of ``n`` samples runs on the card
    (see the note in the CUDA source)."""

    lines: int
    n: int
    kind: str  # "strided": rows contiguous, j strided; "contiguous": each line contiguous
    inner: int  # strided: lines per contiguous run of rows (the axis stride)
    pitch: int  # strided: elements between runs; contiguous: between lines
    jstride: int  # elements between consecutive samples of a line
    cost: str  # "table": the EDT's, built in shared memory; "matrix": read from device memory
    row_groups: int  # warps along the rows of a tile
    rows: int  # R: lines per tile
    tiles: int
    warps: int  # warps a block needs to cover a tile at once
    nj: int  # n padded to the j loop's step of 4
    np_: int  # n padded to the columns one warp covers
    vec: bool  # 16-byte loads and stores
    smem_bytes: int

    def line_base(self, rho: int) -> int:
        """Element offset of sample 0 of line ``rho``."""
        if self.kind == "strided":
            return (rho // self.inner) * self.pitch + rho % self.inner
        return rho * self.pitch


def pass_smem_bytes(n: int, row_groups: int, cost: str) -> int:
    """Dynamic shared memory of one pass: 8 bytes per row for its base
    offset, the cost area, and the ``[nj][R + 4]`` tile."""
    rows = row_groups * WARP_ROWS
    nj = _round_up(n, 4)
    np_ = _round_up(n, WARP_COLS)
    cost_floats = nj + np_ if cost == "table" else 0
    return 8 * rows + 4 * cost_floats + 4 * nj * (rows + TILE_PAD)


def plan(rows: int, n: int, axis_stride: int, smem_optin: int, sms: int, *,
         cost: str = "table", warps: Optional[int] = None, aligned: bool = True) -> PassPlan:
    """Plan one pass over ``rows`` lines of ``n`` samples that lie
    ``axis_stride`` elements apart (1: contiguous lines; else the rows are
    contiguous in runs of ``axis_stride`` and a run is ``n * axis_stride``
    elements long, as along D and H of a ``[V, D, H, W]`` volume).

    ``smem_optin``: shared memory one block may opt in to; ``sms``: SM count;
    ``cost``: "table" for the EDT, "matrix" for a cost matrix; ``warps``:
    the block's warps when another pass fixes them; ``aligned``: every
    pointer is 16-byte aligned. A tile is 32 rows (small tiles spread evenly
    over the SMs and several blocks share one) unless ``warps`` leaves some
    spare; raises ``ValueError`` for a line too long for shared memory."""
    if min(rows, n, axis_stride, sms) <= 0:
        raise ValueError(f"minplus: plan() needs positive sizes, got rows={rows} n={n} "
                         f"axis_stride={axis_stride} sms={sms}")
    if cost not in ("table", "matrix"):
        raise ValueError(f"minplus: plan() cost must be 'table' or 'matrix', got {cost!r}")
    if pass_smem_bytes(n, 1, cost) > smem_optin:
        raise ValueError(f"minplus: a line of {n} samples needs {pass_smem_bytes(n, 1, cost)} bytes "
                         f"of shared memory, the card allows {smem_optin}")
    np_ = _round_up(n, WARP_COLS)
    col_groups = np_ // WARP_COLS
    # warps to cover the column groups in equal rounds: 20 groups -> 10 warps x 2
    own = -(-col_groups // -(-col_groups // MAX_WARPS))
    groups = 1 if warps is None else max(1, warps // col_groups)
    while groups > 1 and (pass_smem_bytes(n, groups, cost) > smem_optin
                          or -(-rows // (groups * WARP_ROWS)) < sms
                          or (groups - 1) * WARP_ROWS >= rows):
        groups -= 1
    r = groups * WARP_ROWS
    contiguous = axis_stride == 1
    vec = aligned and (n % 4 == 0 if contiguous else axis_stride % 4 == 0)
    return PassPlan(
        lines=rows, n=n, kind="contiguous" if contiguous else "strided",
        inner=axis_stride, pitch=n if contiguous else n * axis_stride, jstride=axis_stride,
        cost=cost, row_groups=groups, rows=r, tiles=-(-rows // r),
        warps=own, nj=_round_up(n, 4), np_=np_, vec=vec,
        smem_bytes=pass_smem_bytes(n, groups, cost))


def plan_tiles(p: PassPlan) -> Iterator[Tuple[int, int]]:
    """Every tile of a pass as ``(line_start, line_stop)``: together they
    cover each line exactly once."""
    for t in range(p.tiles):
        yield t * p.rows, min(p.lines, (t + 1) * p.rows)


@dataclass(frozen=True)
class VolumePlan:
    """The three passes of ``squared_edt_volumes`` and the block they share."""

    passes: Tuple[PassPlan, PassPlan, PassPlan]
    threads: int
    smem_bytes: int

    @property
    def tiles(self) -> int:
        return max(p.tiles for p in self.passes)


def plan_volumes(v: int, d: int, h: int, w: int, smem_optin: int, sms: int, *,
                 aligned: bool = True) -> VolumePlan:
    """Plan the passes along D, H and W of V volumes ``[V, D, H, W]``. One
    block shape serves all three: the most warps any pass needs; a pass with
    fewer column groups lays the spare warps along the rows of a taller tile."""
    shapes = ((v * h * w, d, h * w), (v * d * w, h, w), (v * d * h, w, 1))
    own = [plan(lines, n, stride, smem_optin, sms, aligned=aligned) for lines, n, stride in shapes]
    warps = max(p.warps for p in own)
    passes = tuple(plan(lines, n, stride, smem_optin, sms, warps=warps, aligned=aligned)
                   for lines, n, stride in shapes)
    return VolumePlan(passes, 32 * warps, max(p.smem_bytes for p in passes))


# ---- the kernels' binding ---------------------------------------------------


class _PassStruct(ctypes.Structure):
    """``struct Pass`` of the CUDA source, field for field."""

    _fields_ = [("lines", ctypes.c_longlong), ("inner", ctypes.c_longlong),
                ("pitch", ctypes.c_longlong), ("jstride", ctypes.c_longlong),
                ("tiles", ctypes.c_longlong), ("n", ctypes.c_int),
                ("row_groups", ctypes.c_int), ("kind", ctypes.c_int), ("cost_mode", ctypes.c_int),
                ("src_is_mask", ctypes.c_int), ("vec", ctypes.c_int), ("sqrt_out", ctypes.c_int),
                ("spacing", ctypes.c_float)]


def _pass_struct(p: PassPlan, *, spacing: float = 0.0, mask: bool = False,
                 sqrt: bool = False) -> _PassStruct:
    return _PassStruct(p.lines, p.inner, p.pitch, p.jstride, p.tiles, p.n, p.row_groups, _KIND_CODE[p.kind], _COST_CODE[p.cost], int(mask),
                       int(p.vec), int(sqrt), spacing)


class _Cached:
    """A plan as the launcher takes it, kept per (device, shape, options)."""

    __slots__ = ("plan", "passes", "npass", "threads", "grid", "smem", "validated")

    def __init__(self, plan_, passes, threads: int, grid: int, smem: int):
        self.plan = plan_
        self.passes = passes  # ctypes array of _PassStruct
        self.npass = len(passes)
        self.threads = threads
        self.grid = grid
        self.smem = smem
        self.validated = False  # the launcher's co-residency check has passed once


_plans: Dict[tuple, _Cached] = {}
# Four zeroed counters per (device, stream): the kernel hands out tiles with
# them and puts them back to zero before it ends. Launches on one stream run
# in order, so they can share one workspace.
_counters: Dict[Tuple[int, int], torch.Tensor] = {}
_lib = None


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("edt_minplus").lib
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mtta_edt_volumes.argtypes = [p, p, p, p, i, i, i, ll, i, p]
        lib.mtta_edt_volumes.restype = i
        lib.mtta_minplus_f32.argtypes = [p, p, p, p, p, i, i, i, ll, i, p]
        lib.mtta_minplus_f32.restype = i
        lib.mtta_minplus_blocks_per_sm.argtypes = [i, i, ll]
        lib.mtta_minplus_blocks_per_sm.restype = i
        lib.mtta_minplus_pass_bytes.argtypes = []
        lib.mtta_minplus_pass_bytes.restype = i
        lib.mtta_minplus_probe.argtypes = [p, i, i, i, p]
        lib.mtta_minplus_probe.restype = i
        lib.mtta_cuda_error_string.argtypes = [i]
        lib.mtta_cuda_error_string.restype = ctypes.c_char_p
        if lib.mtta_minplus_pass_bytes() != ctypes.sizeof(_PassStruct):
            raise RuntimeError("minplus: struct Pass of the CUDA source and its ctypes mirror differ")
        _lib = lib
    return _lib


def _error(what: str, code: int, detail: str) -> RuntimeError:
    text = _library().mtta_cuda_error_string(code).decode()
    return RuntimeError(f"{what}: kernel launch refused for {detail}: CUDA error {code} ({text})")


def _grid(device: torch.device, matrix: bool, threads: int, smem: int, tiles: int, what: str) -> int:
    """As many blocks as are co-resident on the card, at most one per tile."""
    with torch.cuda.device(device):
        per_sm = _library().mtta_minplus_blocks_per_sm(int(matrix), threads, smem)
    if per_sm < 1:
        raise RuntimeError(f"{what}: a block of {threads} threads and {smem} bytes of shared memory "
                           f"does not fit an SM (occupancy query returned {per_sm})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(tiles, per_sm * sms)


def _launch(fn, what: str, device: torch.device, entry: _Cached, pointers: tuple, detail: str) -> None:
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(fn, what, device, entry, pointers, detail)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    counters = _counters.get((device.index, stream))
    if counters is None:
        counters = torch.zeros(4, dtype=torch.int32, device=device)
        _counters[(device.index, stream)] = counters
    code = fn(*pointers, counters.data_ptr(), entry.passes, entry.npass, entry.threads,
              entry.grid, entry.smem, int(not entry.validated), stream)
    if code != 0:
        raise _error(what, code, detail)
    entry.validated = True
    minplus.launches += 1


def _optin(device: torch.device) -> Tuple[int, int]:
    props = torch.cuda.get_device_properties(device)
    return props.shared_memory_per_block_optin, props.multi_processor_count


def plan_for(f: torch.Tensor) -> PassPlan:
    """The plan ``minplus`` uses for CUDA tensor ``f`` on its device."""
    return _cached_matrix_plan(f, True).plan


def _cached_matrix_plan(f: torch.Tensor, aligned: bool) -> _Cached:
    rows, n = f.shape
    key = ("matrix", f.device.index, rows, n, aligned)
    got = _plans.get(key)
    if got is None:
        p = plan(rows, n, 1, *_optin(f.device), cost="matrix", aligned=aligned)
        threads = 32 * p.warps
        got = _Cached(p, (_PassStruct * 1)(_pass_struct(p)), threads,
                      _grid(f.device, True, threads, p.smem_bytes, p.tiles, "minplus"), p.smem_bytes)
        _plans[key] = got
    return got


def volume_plan_for(points: torch.Tensor) -> VolumePlan:
    """The plan ``squared_edt_volumes`` uses for CUDA tensor ``points``."""
    return plan_volumes(*points.shape, *_optin(points.device))


def _launch_matrix(f: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    if f.shape[1] >= 2**31:
        raise ValueError("minplus: a line must hold fewer than 2**31 samples")
    lib = _library()
    g = torch.empty_like(f)
    aligned = all(t.data_ptr() % 16 == 0 for t in (f, cost, g))
    entry = _cached_matrix_plan(f, aligned)
    _launch(lib.mtta_minplus_f32, "minplus", f.device, entry,
            (f.data_ptr(), cost.data_ptr(), g.data_ptr()), f"f {tuple(f.shape)} with {entry.plan}")
    return g


def _launch_volumes(points: torch.Tensor, spacing: Tuple[float, float, float], sqrt: bool) -> torch.Tensor:
    lib = _library()
    if points.dtype == torch.bool:
        mask = points.view(torch.uint8)
    elif points.dtype == torch.uint8:
        mask = points
    else:
        mask = (points > 0.5).view(torch.uint8)
    out = torch.empty(points.shape, dtype=torch.float32, device=points.device)
    aligned = mask.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    key = ("volumes", points.device.index, tuple(points.shape), spacing, sqrt, aligned)
    entry = _plans.get(key)
    if entry is None:
        vp = plan_volumes(*points.shape, *_optin(points.device), aligned=aligned)
        structs = (_PassStruct * 3)(*(
            _pass_struct(p, spacing=spacing[k], mask=k == 0, sqrt=sqrt and k == 2)
            for k, p in enumerate(vp.passes)))
        entry = _Cached(vp, structs, vp.threads,
                        _grid(points.device, False, vp.threads, vp.smem_bytes, vp.tiles,
                              "squared_edt_volumes"), vp.smem_bytes)
        _plans[key] = entry
    _launch(lib.mtta_edt_volumes, "squared_edt_volumes", points.device, entry,
            (mask.data_ptr(), out.data_ptr()), f"points {tuple(points.shape)}")
    return out


# ---- the operators ----------------------------------------------------------
# Both entries are registered torch operators (``mtta::minplus``,
# ``mtta::squared_edt_volumes``), as the norm's are, so that the port's two
# kernels bind one way: the CPU implementation is the plain version, the CUDA
# one the kernel launch, and no other device has one. Neither has a gradient.


@torch.library.custom_op("mtta::minplus", mutates_args=(), device_types="cpu")
def _minplus_op(f: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    return minplus_plain(f, cost)


@_minplus_op.register_kernel("cuda")
def _minplus_cuda(f, cost):
    return _launch_matrix(f, cost)


@_minplus_op.register_fake
def _minplus_fake(f, cost):
    return torch.empty_like(f)


@torch.library.custom_op("mtta::squared_edt_volumes", mutates_args=(), device_types="cpu")
def _edt_op(points: torch.Tensor, spacing: List[float], sqrt: bool) -> torch.Tensor:
    return squared_edt_volumes_plain(points, spacing, sqrt=sqrt)


@_edt_op.register_kernel("cuda")
def _edt_cuda(points, spacing, sqrt):
    return _launch_volumes(points, tuple(spacing), sqrt)


@_edt_op.register_fake
def _edt_fake(points, spacing, sqrt):
    return points.new_empty(points.shape, dtype=torch.float32)


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {t.device}")


def minplus(f: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """f: [rows, n] f32 with values in [0, +inf]; cost: [n, n] f32, finite.
    Returns g [rows, n] f32 with ``g[r, i] = min_j f[r, j] + cost[j, i]``;
    an all-inf row stays all inf. Launches on the current stream and does
    not synchronise."""
    _check(f, cost)
    _check_device(f, "minplus")
    return _minplus_op(f, cost)


minplus.launches = 0


def squared_edt_volumes(points: torch.Tensor, spacing: Sequence[float], *,
                        sqrt: bool = False) -> torch.Tensor:
    """Exact anisotropic squared EDT of V volumes.

    points: contiguous [V, D, H, W], bool or numbers in {0, 1} (> 0.5 marks
    a point); spacing: the voxel size along D, H, W. Returns [V, D, H, W] f32:
    per voxel the squared distance to the nearest point of its volume (the
    distance itself with ``sqrt=True``), +inf everywhere in a volume without
    points. One kernel launch on the current stream for a CUDA tensor, no
    synchronise; ``minplus.launches`` counts it."""
    spacing = _check_volumes(points, spacing)
    _check_device(points, "squared_edt_volumes")
    return _edt_op(points, list(spacing), bool(sqrt))


def addmin_probe(device: torch.device, blocks: int, iters: int, mode: int = 0) -> int:
    """Launch the register-only probe of the card's add/min instruction rate on
    the current stream (``blocks`` x 256 threads, ``iters`` rounds of 32
    independent chains). mode 0: one f32 add and one f32 min per link, the
    general entry's inner loop; mode 1: two adds and one three-input integer
    min, the EDT's. Returns the adds and candidates-to-min it executes (a
    three-input min counts as two); time it with CUDA events."""
    lib = _library()
    scratch = torch.zeros(4, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        code = lib.mtta_minplus_probe(scratch.data_ptr(), blocks, iters, mode,
                                      torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise _error("addmin_probe", code, f"{blocks} blocks, mode {mode}")
    return blocks * 256 * iters * 32 * (2 if mode == 0 else 4)
