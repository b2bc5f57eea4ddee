"""The port's NIfTI I/O (multimodal_tta_tpu_torch/data/nifti.py, _native.py)
against the JAX package's data/nifti.py and data/_native.py.

Files written by either side read back bitwise equal on both, in the dtypes
and orientations of tests/test_nifti.py and tests/test_native.py, and the
two writers give the same bytes. The native decode path (the host C++ core
``csrc/nifti_native.cpp``, built by the port into ``build/native/``) and the
pure-Python path give the same array, bitwise; ``decode_counts`` says which
path each decode took."""

import gzip
import os
import struct

import numpy as np
import pytest

from multimodal_tta_tpu.data import _native as jax_native
from multimodal_tta_tpu.data import nifti as jax_nifti
from multimodal_tta_tpu_torch.data import _native, nifti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DTYPES = [np.uint8, np.int16, np.int32, np.float32, np.float64]


def _affine(kind: str) -> np.ndarray:
    """The orientations of the JAX NIfTI tests: RAS, one or two flipped axes,
    LPS, and a permutation of the axes (with offsets and a 3 mm axis)."""
    if kind == "ras":
        a = np.diag([1.0, 1.0, 3.0, 1.0])
    elif kind == "x_flipped":
        a = np.diag([-2.0, 1.0, 1.0, 1.0])
    elif kind == "xz_flipped":
        a = np.diag([-2.0, 1.0, -1.0, 1.0])
    elif kind == "lps":
        a = np.diag([-1.0, -1.0, 1.0, 1.0])
    elif kind == "permuted":
        a = np.zeros((4, 4))
        a[2, 0], a[0, 1], a[1, 2], a[3, 3] = 3.0, 1.0, 1.0, 1.0
    else:
        raise ValueError(kind)
    a[:3, 3] = [10.0, -5.0, 2.0]
    return a


ORIENTATIONS = ["ras", "x_flipped", "xz_flipped", "lps", "permuted"]


def _volume(dtype, shape=(5, 6, 7), seed=0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.randint(max(info.min, -1000), min(info.max, 1000) + 1, size=shape).astype(dtype)
    return (rng.randn(*shape) * 100).astype(dtype)


def _read(p) -> bytes:
    with open(p, "rb") as f:
        return f.read()


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("orient", ORIENTATIONS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_files_of_either_side_read_back_bitwise(tmp_path, dtype, orient, ext):
    arr, affine = _volume(dtype), _affine(orient)
    ours, theirs = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
    nifti.save(arr, affine, ours)
    jax_nifti.save(arr, affine, theirs)
    assert _read(ours) == _read(theirs)
    for path in (ours, theirs):
        got, want = nifti.load(path), jax_nifti.load(path)
        assert np.asarray(got.dataobj).dtype == arr.dtype
        np.testing.assert_array_equal(np.asarray(got.dataobj), arr)
        np.testing.assert_array_equal(got.affine, want.affine)
        np.testing.assert_array_equal(got.get_fdata(np.float32), want.get_fdata(np.float32))
        can, can_aff = nifti.load_canonical_with_affine(path)
        want_can, want_aff = jax_nifti.load_canonical_with_affine(path)
        assert can.tobytes() == want_can.tobytes()
        np.testing.assert_array_equal(can_aff, want_aff)
        got_dhw, want_dhw = nifti.load_canonical_dhw(path), jax_nifti.load_canonical_dhw(path)
        assert got_dhw.dtype == np.float32 and got_dhw.tobytes() == want_dhw.tobytes()
        g_aff, g_shape = nifti.peek_canonical_geometry(path)
        w_aff, w_shape = jax_nifti.peek_canonical_geometry(path)
        np.testing.assert_array_equal(g_aff, w_aff)
        assert g_shape == w_shape


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
def test_four_d_and_uint8_masks_match(tmp_path, ext):
    arr4 = _volume(np.float32, shape=(4, 5, 6))[..., None].repeat(3, axis=-1)
    mask = (_volume(np.float32, seed=1) > 50).astype(np.uint8)
    for name, arr, affine in (("v4", arr4, _affine("x_flipped")), ("m", mask, _affine("ras"))):
        ours, theirs = str(tmp_path / f"{name}_p{ext}"), str(tmp_path / f"{name}_j{ext}")
        nifti.save(arr, affine, ours, dtype=arr.dtype)
        jax_nifti.save(arr, affine, theirs, dtype=arr.dtype)
        assert _read(ours) == _read(theirs)
        got = nifti.as_closest_canonical(nifti.load(theirs))
        want = jax_nifti.as_closest_canonical(jax_nifti.load(theirs))
        assert np.asarray(got.dataobj).tobytes() == np.asarray(want.dataobj).tobytes()
        np.testing.assert_array_equal(got.affine, want.affine)


@pytest.mark.parametrize("slope,inter", [(2.0, 5.0), (0.0, 5.0), (float("nan"), 5.0), (2.0, float("nan"))])
def test_scaling_semantics_match(tmp_path, slope, inter):
    p = str(tmp_path / "s.nii")
    jax_nifti.save(np.ones((2, 3, 4), np.int16) * 10, np.eye(4), p)
    raw = bytearray(_read(p))
    struct.pack_into("<2f", raw, 112, slope, inter)
    with open(p, "wb") as f:
        f.write(bytes(raw))
    got = nifti.load(p).get_fdata(np.float32)
    np.testing.assert_array_equal(got, jax_nifti.load(p).get_fdata(np.float32))
    assert nifti.load_canonical_dhw(p).tobytes() == jax_nifti.load_canonical_dhw(p).tobytes()


def test_big_endian_and_bad_magic(tmp_path):
    arr = _volume(np.float32, shape=(3, 3, 3), seed=9)
    p = str(tmp_path / "le.nii")
    jax_nifti.save(arr, np.eye(4), p)
    raw = bytearray(_read(p))
    # the header and the voxels byte-swapped: the same volume, big-endian
    be = bytearray(raw[:352])
    for off, fmt in ((0, "i"), (40, "8h"), (70, "2h"), (76, "8f"), (108, "f"), (112, "2f"), (252, "2h"),
                     (256, "6f"), (280, "12f")):
        struct.pack_into(">" + fmt, be, off, *struct.unpack_from("<" + fmt, raw, off))
    vox = np.frombuffer(bytes(raw[352:]), "<f4").astype(">f4").tobytes()
    pb = str(tmp_path / "be.nii")
    with open(pb, "wb") as f:
        f.write(bytes(be) + vox)
    got, want = nifti.load(pb), jax_nifti.load(pb)
    np.testing.assert_array_equal(np.asarray(got.dataobj), arr)
    np.testing.assert_array_equal(np.asarray(got.dataobj), np.asarray(want.dataobj))
    nifti.decode_counts.reset()
    assert nifti.load_canonical_dhw(pb).tobytes() == jax_nifti.load_canonical_dhw(pb).tobytes()
    assert nifti.decode_counts.snapshot() == {"native": 0, "python": 1}  # the native core reads little-endian only
    junk = str(tmp_path / "junk.nii")
    with open(junk, "wb") as f:
        f.write(b"\x00" * 400)
    for mod in (nifti, jax_nifti):
        with pytest.raises(ValueError):
            mod.load(junk)


def test_canonical_geometry_matches():
    for orient in ORIENTATIONS:
        a, s = nifti.canonical_geometry(_affine(orient), (5, 6, 7))
        b, t = jax_nifti.canonical_geometry(_affine(orient), (5, 6, 7))
        np.testing.assert_array_equal(a, b)
        assert s == t


@pytest.fixture(scope="module")
def native_lib():
    if not _native.available():
        pytest.fail(f"the port's native NIfTI core did not build: {_native.build_log()}")
    return _native.get_lib()


def test_native_core_builds_into_build_native(native_lib):
    path = native_lib._name
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.basename(path).startswith("libnifti_native_") and path.endswith(".so")


@pytest.mark.parametrize("orient", ORIENTATIONS)
@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32, np.float64], ids=lambda d: np.dtype(d).name)
def test_native_and_python_paths_agree_bitwise(native_lib, tmp_path, dtype, ext, orient):
    arr = _volume(dtype, seed=3)
    p = str(tmp_path / f"v{ext}")
    nifti.save(arr, _affine(orient), p)
    nifti.decode_counts.reset()
    fast = nifti.load_canonical_dhw(p)
    python = np.ascontiguousarray(nifti.load_canonical(p, dtype=np.float32).transpose(2, 1, 0))
    assert fast.dtype == np.float32 and fast.flags.c_contiguous
    assert fast.tobytes() == python.tobytes()
    # a permutation of the axes is the one orientation the core leaves to Python
    want_path = "python" if orient == "permuted" else "native"
    assert nifti.decode_counts.snapshot() == {"native": int(want_path == "native"),
                                              "python": int(want_path == "python")}


@pytest.mark.parametrize("dtype,code", [(np.uint8, 2), (np.int16, 4), (np.float32, 16), (np.float64, 64)])
@pytest.mark.parametrize("flips", [(False, False, False), (True, False, True)])
def test_native_cast_reorient_matches_reference_core(native_lib, dtype, code, flips):
    arr = _volume(dtype, seed=4)
    raw = np.asfortranarray(arr).tobytes(order="F")
    got = _native.cast_reorient_f32(raw, code, arr.shape, flips, 2.0, -1.0)
    want = arr[tuple(slice(None, None, -1) if f else slice(None) for f in flips)]
    want = (want.astype(np.float32) * np.float32(2.0) + np.float32(-1.0)).transpose(2, 1, 0)
    np.testing.assert_array_equal(got, want)
    if jax_native.available():
        ref = jax_native.cast_reorient_f32(raw, code, arr.shape, flips, 2.0, -1.0)
        assert got.tobytes() == ref.tobytes()
    # a buffer shorter than the volume is refused before the core reads it
    assert _native.cast_reorient_f32(raw[:-1], code, arr.shape, flips, 1.0, 0.0) is None


def test_native_gunzip(native_lib):
    payload = os.urandom(100_000)
    assert _native.gunzip(gzip.compress(payload), len(payload)) == payload
    assert _native.gunzip(gzip.compress(b"x" * 50_000), 10) == b"x" * 50_000  # a low size hint grows
    assert _native.gunzip(b"not gzip data", 100) is None


def test_decoded_caches_match(tmp_path):
    p = str(tmp_path / "c.nii.gz")
    nifti.save(_volume(np.float32, seed=22), _affine("x_flipped"), p)
    cache = nifti.DecodedCache(max_bytes=10 << 20)
    a, b = cache.get_or_load(p), cache.get_or_load(p)
    assert a is b and (cache.hits, cache.misses) == (1, 1)
    assert a.tobytes() == jax_nifti.load_canonical_dhw(p).tobytes()
    tiny = nifti.DecodedCache(max_bytes=10)
    assert tiny.get_or_load(p) is not tiny.get_or_load(p) and tiny.misses == 2
    cache.clear()
    assert cache.get_or_load(p) is not a
    disk = nifti.DiskDecodedCache(str(tmp_path / "cache"))
    first = disk.get_or_load(p)
    assert len(os.listdir(tmp_path / "cache")) == 1
    second = disk.get_or_load(p)
    assert first.tobytes() == second.tobytes() == a.tobytes()
