"""NIfTI-1 reading/writing in pure numpy (the port's copy of
``multimodal_tta_tpu/data/nifti.py``).

The reference loads volumes with nibabel and reorients them to the closest
canonical (RAS+) orientation before use (reference:
src/datasets/hecktor21.py:25-28, src/datasets/brats.py:84-92). nibabel is not
available in this environment, so the framework ships its own NIfTI-1 codec:

  - .nii and .nii.gz (gzip) containers
  - little/big endian headers (detected via sizeof_hdr)
  - the numeric datatypes that occur in medical imaging practice
  - scl_slope / scl_inter intensity scaling
  - sform/qform affine extraction (sform preferred, quaternion fallback)
  - ``as_closest_canonical``-equivalent reorientation to RAS+

The array convention matches nibabel: ``get_fdata`` returns (X, Y, Z) with the
affine mapping voxel indices to physical mm coordinates.
"""

from __future__ import annotations

import gzip
import os
import struct
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

_HDR_SIZE = 348
_MAGIC_SINGLE = b"n+1\x00"
_MAGIC_PAIR = b"ni1\x00"

# NIfTI datatype code -> numpy dtype
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiHeader:
    dim: Tuple[int, ...]
    datatype: int
    bitpix: int
    pixdim: Tuple[float, ...]
    vox_offset: int
    scl_slope: float
    scl_inter: float
    qform_code: int
    sform_code: int
    quatern: Tuple[float, float, float]
    qoffset: Tuple[float, float, float]
    srow: np.ndarray  # (3, 4)
    byteorder: str = "<"
    descrip: bytes = b""


class NiftiImage:
    """A loaded NIfTI volume: raw array + affine + header."""

    def __init__(self, dataobj: np.ndarray, affine: np.ndarray, header: Optional[NiftiHeader] = None):
        self.dataobj = dataobj
        self.affine = np.asarray(affine, dtype=np.float64)
        self.header = header

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.dataobj.shape

    def get_fdata(self, dtype=np.float64) -> np.ndarray:
        """Return floating-point data with scl_slope/inter applied.

        Scaling semantics follow the NIfTI-1 spec (nifti1.h: "If the
        scl_slope field is zero, no scaling is done") and nibabel's
        ``get_slope_inter``: a zero or non-finite ``scl_slope`` means "no
        scaling stored" and BOTH slope and intercept are ignored; a
        non-finite intercept alongside a valid slope is treated as 0.
        """
        data = np.asarray(self.dataobj, dtype=dtype)
        h = self.header
        if h is not None:
            slope, inter = float(h.scl_slope), float(h.scl_inter)
            if slope == 0.0 or not np.isfinite(slope):
                return data
            if not np.isfinite(inter):
                inter = 0.0
            if slope != 1.0 or inter != 0.0:
                data = data * dtype(slope) + dtype(inter)
        return data


def _open_maybe_gz(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _quaternion_to_affine(h: NiftiHeader) -> np.ndarray:
    b, c, d = h.quatern
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    qfac = h.pixdim[0] if h.pixdim[0] in (-1.0, 1.0) else 1.0
    zooms = np.array([h.pixdim[1], h.pixdim[2], h.pixdim[3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R * zooms
    aff[:3, 3] = h.qoffset
    return aff


def _affine_from_header(h: NiftiHeader) -> np.ndarray:
    if h.sform_code > 0:
        aff = np.eye(4)
        aff[:3, :] = h.srow
        return aff
    if h.qform_code > 0:
        return _quaternion_to_affine(h)
    aff = np.diag([h.pixdim[1] or 1.0, h.pixdim[2] or 1.0, h.pixdim[3] or 1.0, 1.0])
    return aff


def _parse_header(raw: bytes) -> NiftiHeader:
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"NIfTI header truncated: {len(raw)} bytes")
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    bo = "<"
    if sizeof_hdr != _HDR_SIZE:
        (sizeof_hdr,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError("Not a NIfTI-1 file (bad sizeof_hdr)")
        bo = ">"

    dim = struct.unpack_from(bo + "8h", raw, 40)
    datatype, bitpix = struct.unpack_from(bo + "2h", raw, 70)
    pixdim = struct.unpack_from(bo + "8f", raw, 76)
    (vox_offset,) = struct.unpack_from(bo + "f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(bo + "2f", raw, 112)
    descrip = raw[148:228]
    qform_code, sform_code = struct.unpack_from(bo + "2h", raw, 252)
    quatern = struct.unpack_from(bo + "3f", raw, 256)
    qoffset = struct.unpack_from(bo + "3f", raw, 268)
    srow = np.array(
        [
            struct.unpack_from(bo + "4f", raw, 280),
            struct.unpack_from(bo + "4f", raw, 296),
            struct.unpack_from(bo + "4f", raw, 312),
        ],
        dtype=np.float64,
    )
    magic = raw[344:348]
    if magic not in (_MAGIC_SINGLE, _MAGIC_PAIR):
        raise ValueError(f"Unsupported NIfTI magic: {magic!r}")

    return NiftiHeader(
        dim=dim,
        datatype=int(datatype),
        bitpix=int(bitpix),
        pixdim=tuple(float(p) for p in pixdim),
        vox_offset=int(vox_offset) if vox_offset else _HDR_SIZE + 4,
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        qform_code=int(qform_code),
        sform_code=int(sform_code),
        quatern=tuple(float(q) for q in quatern),
        qoffset=tuple(float(q) for q in qoffset),
        srow=srow,
        byteorder=bo,
        descrip=bytes(descrip),
    )


def load(path: str) -> NiftiImage:
    """Load a .nii / .nii.gz file."""
    with _open_maybe_gz(path, "rb") as f:
        raw = f.read()
    h = _parse_header(raw[:_HDR_SIZE])
    ndim = h.dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"Bad ndim in NIfTI header: {ndim}")
    shape = tuple(int(d) for d in h.dim[1 : 1 + ndim])
    if h.datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code: {h.datatype}")
    dt = np.dtype(_DTYPES[h.datatype]).newbyteorder(h.byteorder)

    n_items = int(np.prod(shape))
    start = h.vox_offset
    data = np.frombuffer(raw, dtype=dt, count=n_items, offset=start)
    # NIfTI data is Fortran-ordered (x fastest).
    arr = data.reshape(shape, order="F")
    affine = _affine_from_header(h)
    return NiftiImage(arr, affine, h)


def save(
    arr: np.ndarray,
    affine: np.ndarray,
    path: str,
    dtype: Optional[np.dtype] = None,
) -> None:
    """Write a .nii / .nii.gz single-file NIfTI-1 image with an sform affine."""
    arr = np.asarray(arr)
    if dtype is not None:
        arr = arr.astype(dtype)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    code = _DTYPE_CODES.get(np.dtype(arr.dtype.newbyteorder("=")))
    if code is None:
        raise ValueError(f"Cannot write dtype {arr.dtype} to NIfTI")
    affine = np.asarray(affine, dtype=np.float64)
    if affine.shape != (4, 4):
        raise ValueError("affine must be 4x4")

    ndim = arr.ndim
    dim = [ndim] + list(arr.shape) + [1] * (7 - ndim)
    zooms = np.sqrt(np.sum(affine[:3, :3] ** 2, axis=0))
    pixdim = [1.0] + [float(z) for z in zooms] + [1.0] * (7 - max(ndim, 3))
    pixdim = (pixdim + [1.0] * 8)[:8]
    bitpix = arr.dtype.itemsize * 8

    hdr = bytearray(_HDR_SIZE + 4)  # +4 for the extension flag
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, code, bitpix)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, float(_HDR_SIZE + 4))  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    descrip = b"multimodal_tta_tpu"
    hdr[148 : 148 + len(descrip)] = descrip
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform_code=0, sform_code=1
    struct.pack_into("<4f", hdr, 280, *affine[0, :])
    struct.pack_into("<4f", hdr, 296, *affine[1, :])
    struct.pack_into("<4f", hdr, 312, *affine[2, :])
    hdr[344:348] = _MAGIC_SINGLE

    payload = bytes(hdr) + np.asfortranarray(arr).tobytes(order="F")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if str(path).endswith(".gz"):
        # mtime=0 keeps outputs byte-identical run to run
        with open(path, "wb") as fo:
            with gzip.GzipFile(filename="", fileobj=fo, mode="wb", mtime=0) as gz:
                gz.write(payload)
    else:
        with open(path, "wb") as fo:
            fo.write(payload)


# ----------------------------------------------------------------------------
# Orientation (as_closest_canonical equivalent)
# ----------------------------------------------------------------------------

def io_orientation(affine: np.ndarray) -> np.ndarray:
    """Greedy orientation extraction: for each output (RAS) axis, which input
    axis maps to it and with which sign. Returns (3, 2) array of
    (input_axis, flip) rows indexed by output axis, matching nibabel's
    io_orientation output format for axis-aligned affines."""
    R = np.asarray(affine, dtype=np.float64)[:3, :3].copy()
    # normalize columns to compare directions, guarding zero columns
    norms = np.sqrt(np.sum(R ** 2, axis=0))
    norms[norms == 0] = 1.0
    Q = R / norms

    out = np.full((3, 2), np.nan)
    used_rows, used_cols = set(), set()
    A = np.abs(Q.copy())
    for _ in range(3):
        i, j = np.unravel_index(np.argmax(A), A.shape)  # i=output axis, j=input axis
        out[j, 0] = i
        out[j, 1] = 1.0 if Q[i, j] >= 0 else -1.0
        used_rows.add(i)
        used_cols.add(j)
        A[i, :] = -1.0
        A[:, j] = -1.0
    return out


def apply_orientation_to_canonical(arr: np.ndarray, affine: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Reorient array+affine so the array axes are RAS+ (x:L->R, y:P->A, z:I->S).

    Returns (reoriented array, updated affine). Equivalent to
    nib.as_closest_canonical for the axis-permutation + flip family.
    """
    ornt = io_orientation(affine)  # rows: input axis -> (output axis, sign)
    shape = arr.shape[:3]

    # flip input axes whose direction is negative
    flips = [int(ax) for ax in range(3) if ornt[ax, 1] < 0]
    if flips:
        arr = np.flip(arr, axis=tuple(flips))
    # permute so that input axis with output index k lands at position k
    perm = [0, 1, 2]
    for in_ax in range(3):
        perm[int(ornt[in_ax, 0])] = in_ax
    extra = list(range(3, arr.ndim))
    arr = np.transpose(arr, perm + extra)

    # update the affine: new_affine = affine @ (index transform old<-new)
    new_affine, _ = canonical_geometry(affine, shape)
    return np.ascontiguousarray(arr), new_affine


def as_closest_canonical(img: NiftiImage) -> NiftiImage:
    arr, aff = apply_orientation_to_canonical(np.asarray(img.dataobj), img.affine)
    return NiftiImage(arr, aff, img.header)


def canonical_geometry(affine: np.ndarray, shape_xyz: Tuple[int, int, int]) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Affine+shape of the RAS+-reoriented volume WITHOUT touching voxels.

    Mirrors apply_orientation_to_canonical's affine math (same ornt, same
    index transform) so a writer can reconstruct the exact geometry the
    datasets fed downstream from just the on-disk header.
    """
    affine = np.asarray(affine, dtype=np.float64)
    ornt = io_orientation(affine)
    shape = tuple(int(s) for s in shape_xyz[:3])

    M = np.zeros((3, 3))
    t = np.zeros(3)
    new_shape = [0, 0, 0]
    for in_ax in range(3):
        out_ax = int(ornt[in_ax, 0])
        sign = ornt[in_ax, 1]
        new_shape[out_ax] = shape[in_ax]
        if sign >= 0:
            M[in_ax, out_ax] = 1.0
        else:
            M[in_ax, out_ax] = -1.0
            t[in_ax] = shape[in_ax] - 1
    full = np.eye(4)
    full[:3, :3] = M
    full[:3, 3] = t
    return affine @ full, tuple(new_shape)


def peek_canonical_geometry(path: str) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Header-only read: (canonical RAS+ affine, canonical (X,Y,Z) shape).

    Reads just the 348-byte NIfTI-1 header (streamed for .gz), so geometry
    recovery for prediction export costs no voxel decode.
    """
    with _open_maybe_gz(path, "rb") as f:
        hdr = f.read(_HDR_SIZE)
    h = _parse_header(hdr)
    ndim = h.dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"Bad ndim in NIfTI header: {ndim}")
    shape = tuple(int(d) for d in h.dim[1:4]) if ndim >= 3 else tuple(
        list(h.dim[1 : 1 + ndim]) + [1] * (3 - ndim)
    )
    return canonical_geometry(_affine_from_header(h), shape)


def load_canonical(path: str, dtype=np.float32) -> np.ndarray:
    """Load + reorient to RAS+ and return float data in (X, Y, Z) order.

    Drop-in for the reference helper (reference: src/datasets/hecktor21.py:25-28).
    """
    img = as_closest_canonical(load(path))
    return img.get_fdata(dtype=dtype)


def load_canonical_with_affine(path: str, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    img = as_closest_canonical(load(path))
    return img.get_fdata(dtype=dtype), img.affine


class DecodedCache:
    """Bounded in-memory cache of decoded canonical volumes.

    The reference re-decodes every NIfTI each epoch in its DataLoader workers
    (reference: SURVEY.md §3.4); for 300-epoch runs over modest datasets the
    decode cost dominates host time. Enabled per dataset via
    ``dataset.cache_in_memory``; thread-safe for the HostLoader pool.
    """

    def __init__(self, max_bytes: int = 8 << 30):
        import threading

        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._data: dict = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def clear(self) -> None:
        """Drop all cached volumes (e.g. after a device-resident store has
        been staged and the host copies are dead weight)."""
        with self._lock:
            self._data.clear()
            self._bytes = 0

    def get_or_load(self, path: str) -> np.ndarray:
        with self._lock:
            hit = self._data.get(path)
            if hit is not None:
                self.hits += 1
                return hit
        arr = load_canonical_dhw(path)
        with self._lock:
            self.misses += 1
            if path not in self._data and self._bytes + arr.nbytes <= self.max_bytes:
                self._data[path] = arr
                self._bytes += arr.nbytes
        return arr


class DiskDecodedCache:
    """Persistent pre-decoded volume cache (MONAI-PersistentDataset analogue).

    First access decodes the NIfTI and writes the canonical (D,H,W) float32
    array as a raw ``.npy`` next to nothing else in ``cache_dir`` (atomic
    tmp+rename, keyed by source path+mtime+size so stale entries self-bust);
    later accesses are a plain file read — on a warm page cache that is
    memcpy speed, vs ~20 ms/volume of gzip inflate. Enabled per dataset via
    ``dataset.decode_cache_dir``. Safe under concurrent readers/writers
    (worst case two threads both decode and one rename wins).
    """

    def __init__(self, cache_dir: str):
        import hashlib

        self.cache_dir = str(cache_dir)
        os.makedirs(self.cache_dir, exist_ok=True)
        self._hash = hashlib.sha1

    def _slot(self, path: str) -> str:
        st = os.stat(path)
        key = f"{os.path.abspath(path)}:{st.st_mtime_ns}:{st.st_size}"
        return os.path.join(self.cache_dir, self._hash(key.encode()).hexdigest() + ".npy")

    def get_or_load(self, path: str) -> np.ndarray:
        slot = self._slot(path)
        try:
            return np.load(slot)
        except (OSError, ValueError):
            pass  # miss (or torn write from a crashed process): re-decode
        arr = load_canonical_dhw(path)
        tmp = slot + f".tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, slot)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return arr


class DecodeCounts:
    """How many volumes ``load_canonical_dhw`` decoded on each path: the
    native C++ core (``native``) or the pure-Python fallback (``python``).
    Thread-safe: the host loader decodes in a thread pool."""

    def __init__(self):
        self._lock = threading.Lock()
        self.native = 0
        self.python = 0

    def add(self, path: str) -> None:
        with self._lock:
            setattr(self, path, getattr(self, path) + 1)

    def reset(self) -> None:
        with self._lock:
            self.native = self.python = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"native": self.native, "python": self.python}


decode_counts = DecodeCounts()


def _load_canonical_dhw_native(path: str) -> Optional[np.ndarray]:
    """The native core's decode of ``path``, or None where it does not apply
    (no library, another byte order, dimensionality, dtype or an axis
    permutation)."""
    from . import _native

    if not _native.available():
        return None
    with open(path, "rb") as f:
        blob = f.read()
    if str(path).endswith(".gz"):
        # size hint: ISIZE footer stores uncompressed size mod 2^32
        (isize,) = struct.unpack("<I", blob[-4:])
        raw = _native.gunzip(blob, max(isize, 1 << 20))
    else:
        raw = blob
    if raw is None:
        return None
    h = _parse_header(raw[:_HDR_SIZE])
    if not (h.byteorder == "<" and h.dim[0] == 3 and h.datatype in (2, 4, 8, 16, 64, 256, 512, 768)):
        return None
    affine = _affine_from_header(h)
    ornt = io_orientation(affine)
    if not all(int(ornt[i, 0]) == i for i in range(3)):
        return None
    shape = tuple(int(d) for d in h.dim[1:4])
    flips = [ornt[i, 1] < 0 for i in range(3)]
    # same NIfTI-1 scaling semantics as get_fdata:
    # slope==0 / non-finite -> no scaling AT ALL
    slope, inter = float(h.scl_slope), float(h.scl_inter)
    if slope == 0.0 or not np.isfinite(slope):
        slope, inter = 1.0, 0.0
    elif not np.isfinite(inter):
        inter = 0.0
    return _native.cast_reorient_f32(raw[h.vox_offset:], h.datatype, shape, flips, slope, inter)


def load_canonical_dhw(path: str) -> np.ndarray:
    """Load + canonicalize + return float32 in (D,H,W) = (Z,Y,X) order — the
    layout the datasets feed to the device.

    Fast path: the native C++ core (csrc/nifti_native.cpp, bound by
    ``_native.py``) fuses gunzip + cast + flips + the (X,Y,Z)->(Z,Y,X)
    transpose into one pass with the GIL released. Applies when the volume
    is little-endian, 3-D, a supported dtype, and its orientation is
    axis-aligned without permutation (the overwhelmingly common case for
    preprocessed data); otherwise, or when the native decode fails, the
    pure-Python path gives the same array. ``decode_counts`` counts which
    path each call took.
    """
    try:
        out = _load_canonical_dhw_native(path)
    except (OSError, ValueError, struct.error):
        out = None  # fall through to the Python path, which reports the fault
    if out is not None:
        decode_counts.add("native")
        return out
    out = np.ascontiguousarray(load_canonical(path, dtype=np.float32).transpose(2, 1, 0))
    decode_counts.add("python")
    return out
