"""Physical-space 3D resampling on the device (the port of
``multimodal_tta_tpu/ops/resample.py``, the SimpleITK replacement of the
offline preprocessing).

  - ``Grid``: ITK-style image geometry (origin, spacing, direction, size) in
    ITK's LPS physical convention, built from a NIfTI RAS affine, so bbox CSVs
    authored against ITK physical coordinates read as the reference reads
    them. Pure numpy; the port keeps its own copy.
  - ``resample_to_spacing``: regrid to a target spacing keeping the origin,
    direction and field of view (size = round(old_size * old_spacing /
    new_spacing)).
  - ``resample_to_reference``: identity-transform regrid of a moving image
    onto a reference grid.
  - trilinear and nearest interpolation, pixel-centre aligned as ITK, with a
    default value outside the moving image's half-voxel-padded field of view.

Host numpy goes in and host numpy comes out, as in the JAX functions, since
the callers read and write NIfTI. In between, the interpolation runs as torch
ops on ``device`` (the JAX package's ``use_jax`` flag). It is not
``F.grid_sample``: its normalised coordinates round differently and its
``padding_mode`` is not the half-voxel border rule.

Coordinates. The reference forms ``M @ idx + t`` as an f32 dot, which XLA:CPU
computes as a chain of fused multiply-adds, each rounded to f32 once. The port
takes each step in f64 (a product of two f32 values is exact there) and
rounds it to f32, elementwise, with no matmul: so no TF32 and no reordered
sum, and the same bits on the CPU and the card. With a diagonal ``M``
(``resample_to_spacing``, and the HECKTOR PET/GT -> CT maps) every step's
``a * b + c`` is exact in f64, so the one rounding to f32 is the fused
multiply-add's, and the floor and the round-half-to-even (``torch.round``,
as ``jnp.round``) give XLA's indices bit for bit: nearest-resampled labels
are equal. With a non-diagonal ``M`` (a rotated or sheared direction) a step
whose sum is not exact in f64 is rounded twice, f64 then f32, and can land
on the other side of an f32 midpoint than the single rounding: a coordinate
may then sit an ulp from XLA's, and a nearest label can differ at a rare
voxel whose coordinate lies on a half. The trilinear chain is the reference's formula as separate torch ops
(so again the same bits on the CPU and the card); XLA:CPU fuses part of it
into multiply-adds, so linear values sit within an ulp or two of the
reference's.

The moving volume goes to the device in its memory order, and the output
comes back in the same order: a NIfTI volume as read is Fortran-ordered (x
fastest), so neighbouring output voxels gather from neighbouring input
voxels, with no transposing copy on the host. The values do not depend on
the order.

Memory. The output is produced in slabs of flat output indices under a byte
budget (as ``ops/surface.py`` groups its pairs): per slab the coordinates,
one flat int64 index per corner and its gathered value (``torch.take``), so a
CT of 512x512x128 resampled to [1, 1, 3] mm (32M output voxels) never holds
its 3 x N coordinates or eight index tensors at once.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device

_RAS2LPS = np.diag([-1.0, -1.0, 1.0])

# Temporaries of one slab stay under this budget. Per output voxel of a
# linear slab: the flat output index and three f64 coordinates (32 bytes),
# three f32 coordinates and fractions (24), three int64 floors (24), the
# corner's flat index (8), the eight corner values and the lerp chain's
# partials (about 64).
_SLAB_BYTES = 512 << 20
_BYTES_PER_VOXEL = 160


@dataclass(frozen=True)
class Grid:
    """ITK-style image geometry in LPS space. Array layout is (X, Y, Z)."""

    origin: np.ndarray  # (3,)
    spacing: np.ndarray  # (3,)
    direction: np.ndarray  # (3,3) unit column vectors
    size: Tuple[int, int, int]

    @classmethod
    def from_ras_affine(cls, affine: np.ndarray, size: Sequence[int]) -> "Grid":
        """Build from a NIfTI RAS affine (the NIfTI reader's convention)."""
        A = _RAS2LPS @ np.asarray(affine, np.float64)[:3, :3]
        origin = _RAS2LPS @ np.asarray(affine, np.float64)[:3, 3]
        spacing = np.sqrt((A ** 2).sum(axis=0))
        spacing[spacing == 0] = 1.0
        direction = A / spacing
        return cls(origin=origin, spacing=spacing, direction=direction, size=tuple(int(s) for s in size))

    def to_ras_affine(self) -> np.ndarray:
        aff = np.eye(4)
        A = self.direction @ np.diag(self.spacing)
        aff[:3, :3] = _RAS2LPS @ A
        aff[:3, 3] = _RAS2LPS @ self.origin
        return aff

    def index_to_physical(self, idx: np.ndarray) -> np.ndarray:
        """Continuous index (..., 3) -> physical LPS point (..., 3)."""
        idx = np.asarray(idx, np.float64)
        return idx @ (self.direction @ np.diag(self.spacing)).T + self.origin

    def physical_to_continuous_index(self, pts: np.ndarray) -> np.ndarray:
        pts = np.asarray(pts, np.float64)
        inv = np.diag(1.0 / self.spacing) @ self.direction.T
        return (pts - self.origin) @ inv.T


def _affine_between(moving: Grid, ref: Grid) -> Tuple[np.ndarray, np.ndarray]:
    """Index-space map ref_index -> moving_continuous_index: i_m = M i_r + t."""
    A_m_inv = np.diag(1.0 / moving.spacing) @ moving.direction.T
    A_r = ref.direction @ np.diag(ref.spacing)
    M = A_m_inv @ A_r
    t = A_m_inv @ (ref.origin - moving.origin)
    return M, t


def _coords(flat: torch.Tensor, out_shape: Tuple[int, int, int], M: np.ndarray, t: np.ndarray,
            fortran: bool = False):
    """The continuous moving indices (cx, cy, cz), f32, of the flat output
    indices ``flat`` (int64; x fastest when ``fortran``, else z): row r is
    ``fma(M[r,2], iz, fma(M[r,1], iy, M[r,0] * ix)) + t[r]``, each step
    taken in f64 and rounded to f32: XLA:CPU's dot bit for bit where each
    step is exact in f64 (a diagonal ``M``), else possibly an ulp off."""
    ox, oy, oz = out_shape
    if fortran:
        idx = [(flat % ox).double(), ((flat // ox) % oy).double(), (flat // (ox * oy)).double()]
    else:
        idx = [(flat // (oy * oz)).double(), ((flat // oz) % oy).double(), (flat % oz).double()]
    out = []
    for r in range(3):
        c = (float(M[r, 0]) * idx[0]).float()
        for k in (1, 2):
            c = (float(M[r, k]) * idx[k] + c.double()).float()
        out.append(c + torch.tensor(float(t[r]), dtype=torch.float32, device=flat.device))
    return out


def _interp(flat_data: torch.Tensor, shape: Tuple[int, int, int], strides: Tuple[int, int, int], coords,
            method: str, default_value: float) -> torch.Tensor:
    """The reference's ``_interp_core`` on one slab: ``flat_data`` the moving
    volume (X,Y,Z) ``shape`` as a flat tensor on the device, its element
    ``strides``; ``coords`` three f32 tensors of continuous indices."""
    sx, sy, sz = shape
    cx, cy, cz = coords
    inb = ((cx >= -0.5) & (cx <= sx - 0.5) & (cy >= -0.5) & (cy <= sy - 0.5)
           & (cz >= -0.5) & (cz <= sz - 0.5))
    default = torch.tensor(default_value, dtype=flat_data.dtype, device=flat_data.device)

    def gather(xi, yi, zi):
        xi, yi, zi = xi.clamp(0, sx - 1), yi.clamp(0, sy - 1), zi.clamp(0, sz - 1)
        return torch.take(flat_data, xi * strides[0] + yi * strides[1] + zi * strides[2])

    if method == "nearest":
        return torch.where(inb, gather(torch.round(cx).long(), torch.round(cy).long(),
                                       torch.round(cz).long()), default)
    if method != "linear":
        raise ValueError(f"Unknown interpolation: {method}")

    x0, y0, z0 = torch.floor(cx), torch.floor(cy), torch.floor(cz)
    dt = flat_data.dtype
    fx, fy, fz = (cx - x0).to(dt), (cy - y0).to(dt), (cz - z0).to(dt)
    x0, y0, z0 = x0.long(), y0.long(), z0.long()

    def lerp(a, b, f):
        return a * (1 - f) + b * f

    c00 = lerp(gather(x0, y0, z0), gather(x0 + 1, y0, z0), fx)
    c10 = lerp(gather(x0, y0 + 1, z0), gather(x0 + 1, y0 + 1, z0), fx)
    c01 = lerp(gather(x0, y0, z0 + 1), gather(x0 + 1, y0, z0 + 1), fx)
    c11 = lerp(gather(x0, y0 + 1, z0 + 1), gather(x0 + 1, y0 + 1, z0 + 1), fx)
    vals = lerp(lerp(c00, c10, fy), lerp(c01, c11, fy), fz)
    return torch.where(inb, vals, default)


def affine_gather_resample(
    data: np.ndarray,
    M: np.ndarray,
    t: np.ndarray,
    out_shape: Tuple[int, int, int],
    *,
    method: str = "linear",
    default_value: float = 0.0,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Sample ``data`` (X,Y,Z) at continuous indices M @ i + t for every output
    index i in ``out_shape`` on ``device``; out of bounds -> ``default_value``.
    ``M`` and ``t`` are taken in f32, as the reference's jitted core takes
    them; integer or f64 data is taken in f32 (as JAX without x64 takes
    f64, and as its nearest path returns integers)."""
    dev = resolve_device(device)
    if method not in ("linear", "nearest"):
        raise ValueError(f"Unknown interpolation: {method}")
    M = np.asarray(M, np.float32).reshape(3, 3)
    t = np.asarray(t, np.float32).reshape(3)
    out_shape = tuple(int(s) for s in out_shape)
    arr = np.asarray(data)
    if arr.dtype == np.float64 or not np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)  # keeps the memory order
    sx, sy, sz = arr.shape
    fortran = arr.flags.f_contiguous and not arr.flags.c_contiguous  # a NIfTI volume as read: x fastest
    if fortran:
        flat_host, strides = arr.T.reshape(-1), (1, sx, sx * sy)
    else:
        flat_host, strides = np.ascontiguousarray(arr).reshape(-1), (sy * sz, sz, 1)
    with warnings.catch_warnings():  # a read-only array (the NIfTI reader's buffer) is only read here
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        flat_data = torch.from_numpy(flat_host).to(dev)
    n = int(np.prod(out_shape))
    out = torch.empty(n, dtype=flat_data.dtype, device=dev)
    step = max(_SLAB_BYTES // _BYTES_PER_VOXEL, 1)
    for a in range(0, n, step):
        flat = torch.arange(a, min(a + step, n), dtype=torch.int64, device=dev)
        out[a:a + flat.numel()] = _interp(flat_data, arr.shape, strides, _coords(flat, out_shape, M, t, fortran),
                                          method, float(default_value))
    if fortran:
        return out.reshape(out_shape[::-1]).cpu().numpy().T
    return out.reshape(out_shape).cpu().numpy()


def resample_to_spacing(
    data: np.ndarray,
    grid: Grid,
    target_spacing: Sequence[float],
    *,
    method: str = "linear",
    default_value: float = 0.0,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, Grid]:
    """Regrid to ``target_spacing`` keeping origin, direction and field of view
    (reference: prepare_hecktor21.py:96-120)."""
    old_spacing = grid.spacing
    old_size = np.asarray(grid.size, np.int64)
    new_spacing = np.asarray([float(s) for s in target_spacing])
    new_size = np.maximum(np.round(old_size * (old_spacing / new_spacing)).astype(np.int64), 1)

    # same origin/direction: the index map is a pure diagonal scale
    M = np.diag(new_spacing / old_spacing)
    t = np.zeros(3)
    out = affine_gather_resample(data, M, t, tuple(int(s) for s in new_size),
                                 method=method, default_value=default_value, device=device)
    new_grid = replace(grid, spacing=new_spacing, size=tuple(int(s) for s in new_size))
    return out, new_grid


def resample_to_reference(
    data: np.ndarray,
    grid: Grid,
    ref_grid: Grid,
    *,
    method: str = "linear",
    default_value: float = 0.0,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, Grid]:
    """Identity-transform regrid onto ``ref_grid`` (reference: 79-93)."""
    M, t = _affine_between(grid, ref_grid)
    out = affine_gather_resample(data, M, t, ref_grid.size, method=method, default_value=default_value,
                                 device=device)
    return out, ref_grid


def bbox_mm_to_index_roi(grid: Grid, x1: float, x2: float, y1: float, y2: float, z1: float, z2: float):
    """Physical-space bbox (mm, ITK LPS) -> axis-aligned index ROI, robust to
    direction flips via all 8 corners (reference: 123-165)."""
    corners = np.array([(x, y, z) for x in (x1, x2) for y in (y1, y2) for z in (z1, z2)])
    idxs = grid.physical_to_continuous_index(corners)
    start = np.floor(idxs.min(axis=0)).astype(int)
    end = np.ceil(idxs.max(axis=0)).astype(int)
    size = (end - start + 1).astype(int)
    dbg = {
        "corners_mm": corners.tolist(),
        "corners_cont_idx": idxs.tolist(),
        "start_idx": start.tolist(),
        "end_idx": end.tolist(),
        "roi_size": size.tolist(),
    }
    return start.tolist(), size.tolist(), dbg


def pad_image(data: np.ndarray, grid: Grid, pad_before: Sequence[int], pad_after: Sequence[int],
              value: float) -> Tuple[np.ndarray, Grid]:
    """Constant-pad; the origin shifts by -pad_before voxels in physical space."""
    pb = [int(p) for p in pad_before]
    pa = [int(p) for p in pad_after]
    out = np.pad(data, list(zip(pb, pa)), constant_values=value)
    shift = grid.direction @ (grid.spacing * (-np.asarray(pb, np.float64)))
    new_grid = replace(grid, origin=grid.origin + shift,
                       size=tuple(int(s + b + a) for s, b, a in zip(grid.size, pb, pa)))
    return out, new_grid


def crop_image(data: np.ndarray, grid: Grid, start: Sequence[int], size: Sequence[int]) -> Tuple[np.ndarray, Grid]:
    st = [int(s) for s in start]
    sz = [int(s) for s in size]
    out = data[st[0]:st[0] + sz[0], st[1]:st[1] + sz[1], st[2]:st[2] + sz[2]]
    shift = grid.direction @ (grid.spacing * np.asarray(st, np.float64))
    new_grid = replace(grid, origin=grid.origin + shift, size=tuple(sz))
    return np.ascontiguousarray(out), new_grid
