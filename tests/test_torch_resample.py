"""Parity of the port's resampler (multimodal_tta_tpu_torch/ops/resample.py)
with the JAX one (multimodal_tta_tpu/ops/resample.py, its XLA:CPU core) on
the same seeded arrays and grids.

Tolerances: nearest-resampled values (labels) equal; linear values within
1e-5 of the data's range (XLA:CPU fuses part of the trilinear chain into
multiply-adds, the port does not: an ulp or two apart); coordinates, and so
the in-bounds masks and the default value's voxels, equal; geometry (grids,
ROIs, pad/crop origins) exactly."""

import numpy as np
import pytest

from multimodal_tta_tpu.ops import resample as jres
from multimodal_tta_tpu_torch.ops import resample as tres

LINEAR_REL = 1e-5


def _grid(mod, spacing=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0), size=(8, 8, 8), direction=None):
    return mod.Grid(origin=np.asarray(origin, float), spacing=np.asarray(spacing, float),
                    direction=np.eye(3) if direction is None else np.asarray(direction, float), size=tuple(size))


def _both(make):
    """The same grid built in both packages (``make(module)``)."""
    return make(jres), make(tres)


def _rotation(rng, deg):
    a = np.deg2rad(deg)
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * (k @ k)


def _assert_linear(got, want, data):
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = LINEAR_REL * float(np.ptp(data))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("case", ["ras_roundtrip", "lps", "index_physical", "rotated"])
def test_grid_round_trips(case):
    rng = np.random.RandomState(0)
    if case == "ras_roundtrip":
        aff = np.diag([1.0, 1.0, 3.0, 1.0])
        aff[:3, 3] = [5.0, -7.0, 2.0]
    elif case == "lps":
        aff = np.eye(4)
        aff[:3, 3] = [1.0, 2.0, 3.0]
    else:
        aff = np.eye(4)
        aff[:3, :3] = (_rotation(rng, 30.0) if case == "rotated" else np.eye(3)) @ np.diag([2.0, 0.7, 3.0])
        aff[:3, 3] = rng.randn(3) * 10
    j, t = jres.Grid.from_ras_affine(aff, (10, 11, 12)), tres.Grid.from_ras_affine(aff, (10, 11, 12))
    for f in ("origin", "spacing", "direction"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    assert t.size == j.size
    np.testing.assert_array_equal(t.to_ras_affine(), j.to_ras_affine())
    np.testing.assert_allclose(t.to_ras_affine(), aff, atol=1e-12)
    idx = rng.rand(5, 3) * 10
    p = t.index_to_physical(idx)
    np.testing.assert_array_equal(p, j.index_to_physical(idx))
    np.testing.assert_allclose(t.physical_to_continuous_index(p), idx, atol=1e-10)
    np.testing.assert_array_equal(t.physical_to_continuous_index(p), j.physical_to_continuous_index(p))


SPACING_CASES = {
    "down": ((8, 9, 7), (1.0, 1.0, 1.0), (2.0, 1.5, 1.3)),
    "up": ((7, 8, 9), (1.0, 2.0, 1.0), (0.7, 1.0, 0.5)),
    "hecktor_ct": ((20, 20, 6), (0.977, 0.977, 3.0), (1.0, 1.0, 3.0)),
}


@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("case", sorted(SPACING_CASES))
def test_resample_to_spacing_matches_reference(case, method):
    size, spacing, target = SPACING_CASES[case]
    rng = np.random.RandomState(1)
    data = (rng.rand(*size) * 2000 - 1000).astype(np.float32)
    if method == "nearest":
        data = np.rint(data / 500).astype(np.float32)  # a label map
    gj, gt = _both(lambda m: _grid(m, spacing=spacing, origin=(3.0, -2.0, 1.0), size=size))
    want, wg = jres.resample_to_spacing(data, gj, target, method=method, default_value=-7.0)
    got, tg = tres.resample_to_spacing(data, gt, target, method=method, default_value=-7.0, device="cpu")
    assert tg.size == wg.size
    np.testing.assert_array_equal(tg.spacing, wg.spacing)
    np.testing.assert_array_equal(tg.origin, wg.origin)
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        _assert_linear(got, want, data)


REFERENCE_CASES = ["shifted", "flipped", "rotated_pet", "out_of_fov"]


@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_resample_to_reference_matches_reference(case, method):
    rng = np.random.RandomState(2)
    size = (12, 11, 9)
    data = (rng.rand(*size) * 10).astype(np.float32)
    if method == "nearest":
        data = (rng.rand(*size) > 0.6).astype(np.float32)
    moving = dict(spacing=(2.0, 2.1, 3.0), origin=(-1.0, 2.0, 0.5), size=size)
    ref = dict(spacing=(1.0, 1.0, 3.0), origin=(0.3, 1.7, 0.0), size=(20, 22, 9))
    if case == "flipped":
        moving["direction"] = np.diag([-1.0, 1.0, 1.0])
        moving["origin"] = (20.0, 2.0, 0.5)
    elif case == "rotated_pet":
        moving["direction"] = _rotation(rng, 12.0)
    elif case == "out_of_fov":
        ref["origin"] = (100.0, 0.0, 0.0)
    mj, mt = _both(lambda m: _grid(m, **moving))
    rj, rt = _both(lambda m: _grid(m, **ref))
    want, _ = jres.resample_to_reference(data, mj, rj, method=method, default_value=-3.0)
    got, g = tres.resample_to_reference(data, mt, rt, method=method, default_value=-3.0, device="cpu")
    assert g is rt
    np.testing.assert_array_equal(got == -3.0, want == -3.0)  # the same voxels out of the field of view
    if case == "out_of_fov":
        assert (got == -3.0).all()
    else:
        assert (got != -3.0).any()
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        _assert_linear(got, want, data)


def test_coordinates_are_xla_dot_bits():
    """The f32 map M @ i + t bit for bit as XLA:CPU forms it, for a dense
    M (the fused multiply-add chain) and the diagonal ones of the CLIs."""
    import jax
    import jax.numpy as jnp
    import torch

    rng = np.random.RandomState(3)
    out_shape = (9, 10, 11)
    flat = torch.arange(int(np.prod(out_shape)), dtype=torch.int64)
    for M in (rng.randn(3, 3), np.diag([0.977, 0.977, 1.0]), np.diag([1.0 / 4.07, 1.0 / 4.07, 1.0])):
        M = M.astype(np.float32)
        t = (rng.randn(3) * 5).astype(np.float32)
        want = np.asarray(jax.jit(lambda m, v: jres._make_coords(m, v, out_shape, jnp))(M, t))
        got = np.stack([c.numpy() for c in tres._coords(flat, out_shape, M, t)])
        np.testing.assert_array_equal(got, want)


def test_slabs_equal_one_pass(monkeypatch):
    """A volume resampled in many slabs equals the one-slab result."""
    rng = np.random.RandomState(4)
    data = rng.rand(10, 12, 8).astype(np.float32)
    M, t = np.diag([0.7, 0.8, 0.9]) + rng.randn(3, 3) * 0.05, rng.randn(3)
    whole = tres.affine_gather_resample(data, M, t, (13, 11, 9), device="cpu")
    monkeypatch.setattr(tres, "_SLAB_BYTES", 100 * tres._BYTES_PER_VOXEL)
    np.testing.assert_array_equal(tres.affine_gather_resample(data, M, t, (13, 11, 9), device="cpu"), whole)


def test_bbox_rois_match_reference():
    cases = [
        (dict(spacing=(2.0, 2.0, 2.0), size=(20, 20, 20)), (2.0, 6.0, 0.0, 4.0, 2.0, 10.0)),
        (dict(origin=(10.0, 0.0, 0.0), size=(11, 11, 11), direction=np.diag([-1.0, 1.0, 1.0])),
         (2.0, 5.0, 1.0, 2.0, 1.0, 2.0)),
        (dict(spacing=(0.977, 0.977, 3.0), origin=(-250.0, -250.0, -190.0), size=(500, 500, 128)),
         (-72.0, 72.0, -60.0, 84.0, -100.0, 44.0)),
    ]
    for grid_kw, box in cases:
        gj, gt = _both(lambda m: _grid(m, **grid_kw))
        assert tres.bbox_mm_to_index_roi(gt, *box) == jres.bbox_mm_to_index_roi(gj, *box)
    gj, gt = _both(lambda m: _grid(m, spacing=(2.0, 2.0, 2.0), size=(20, 20, 20)))
    start, size, _ = tres.bbox_mm_to_index_roi(gt, 2.0, 6.0, 0.0, 4.0, 2.0, 10.0)
    assert start == [1, 0, 1] and size == [3, 3, 5]


@pytest.mark.parametrize("direction", ["identity", "flipped"])
def test_pad_and_crop_origins_match_reference(direction):
    d = np.eye(3) if direction == "identity" else np.diag([-1.0, 1.0, -1.0])
    gj, gt = _both(lambda m: _grid(m, spacing=(2.0, 1.0, 3.0), origin=(1.0, 2.0, 3.0), size=(4, 5, 6),
                                   direction=d))
    data = np.arange(120, dtype=np.float32).reshape(4, 5, 6)
    for j, t in ((jres.pad_image(data, gj, [1, 0, 2], [0, 3, 1], -5.0),
                  tres.pad_image(data, gt, [1, 0, 2], [0, 3, 1], -5.0)),
                 (jres.crop_image(data, gj, [1, 2, 0], [2, 2, 4]), tres.crop_image(data, gt, [1, 2, 0], [2, 2, 4]))):
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1].origin, j[1].origin)
        assert t[1].size == j[1].size
    out, og = tres.pad_image(data, gt, [1, 0, 0], [0, 0, 0], -5.0)
    assert out[0, 0, 0] == -5.0
    np.testing.assert_allclose(og.index_to_physical(np.array([[1, 0, 0]])), gt.index_to_physical(np.zeros((1, 3))))


def test_integer_and_f64_data_are_taken_in_f32():
    rng = np.random.RandomState(5)
    labels = rng.randint(0, 3, size=(6, 7, 5)).astype(np.uint8)
    g = _grid(tres, size=(6, 7, 5))
    ref = _grid(tres, origin=(0.4, -0.3, 0.2), size=(6, 7, 5))
    got, _ = tres.resample_to_reference(labels, g, ref, method="nearest", device="cpu")
    want, _ = jres.resample_to_reference(labels.astype(np.float32), _grid(jres, size=(6, 7, 5)),
                                         _grid(jres, origin=(0.4, -0.3, 0.2), size=(6, 7, 5)), method="nearest")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    f64, _ = tres.resample_to_spacing(labels.astype(np.float64), g, (1.5, 1.5, 1.5), device="cpu")
    assert f64.dtype == np.float32


def test_errors_and_default_device():
    with pytest.raises(ValueError, match="Unknown interpolation"):
        tres.affine_gather_resample(np.zeros((2, 2, 2), np.float32), np.eye(3), np.zeros(3), (2, 2, 2),
                                    method="cubic", device="cpu")
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tres.resample_to_spacing(np.zeros((2, 2, 2), np.float32), _grid(tres, size=(2, 2, 2)), (1, 1, 1))


@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_fortran_ordered_volume_equals_c_ordered(method):
    """A volume as the NIfTI reader gives it (x fastest) is gathered through
    its strides and comes back x fastest too: the same values as from its
    C-ordered copy, and as the reference's."""
    rng = np.random.RandomState(6)
    c = (rng.rand(9, 10, 7) * 50).astype(np.float32)
    f = np.asfortranarray(c)
    assert f.flags.f_contiguous and not f.flags.c_contiguous
    M, t = np.diag([0.8, 0.9, 1.2]) + rng.randn(3, 3) * 0.05, rng.randn(3)
    got_f = tres.affine_gather_resample(f, M, t, (11, 10, 6), method=method, device="cpu")
    got_c = tres.affine_gather_resample(c, M, t, (11, 10, 6), method=method, device="cpu")
    assert got_f.flags.f_contiguous and got_c.flags.c_contiguous
    np.testing.assert_array_equal(got_f, got_c)
    want = jres.affine_gather_resample(f, M, t, (11, 10, 6), method=method)
    if method == "nearest":
        np.testing.assert_array_equal(got_f, want)
    else:
        _assert_linear(got_f, want, c)
