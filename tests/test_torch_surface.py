"""Parity of the port's surface metrics (multimodal_tta_tpu_torch/ops/
surface.py) with the JAX ones on the CPU, where the EDT's min-plus passes
take the kernel's plain version.

Tolerances: surfaces and the squared EDT (sums of exactly representable
squares at these sizes) must be equal; HD95/ASD/NSD agree within 1e-5
absolute (f32 sums and the percentile's interpolation in another order);
the EDT agrees with scipy within 1e-5 relative. The port takes ASD's distance
sums in f64 (the reference in f32): ASD_RTOL below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from multimodal_tta_tpu.ops import surface as jsurf
from multimodal_tta_tpu_torch.ops import surface as tsurf

torch.set_num_threads(1)

ATOL = 1e-5


def ball(shape, center, r):
    grids = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    d2 = sum((g - c) ** 2 for g, c in zip(grids, center))
    return (d2 <= r * r).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got[~inf], want[~inf], atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["random", "full", "empty", "ball"])
def test_extract_surface(case):
    m = {
        "random": (np.random.RandomState(0).rand(10, 12, 9) > 0.6).astype(np.float32),
        "full": np.ones((4, 4, 4), np.float32),
        "empty": np.zeros((3, 4, 5), np.float32),
        "ball": ball((12, 12, 12), (6, 6, 6), 4),
    }[case]
    got = tsurf.extract_surface(torch.from_numpy(m))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsurf.extract_surface(jnp.asarray(m))))
    want = m.astype(bool) & ~ndimage.binary_erosion(m.astype(bool), border_value=0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (3.0, 1.0, 1.0), (0.5, 2.0, 1.25)])
def test_squared_edt(spacing):
    pts = np.random.RandomState(1).rand(9, 14, 11) > 0.97
    got = tsurf.squared_edt(torch.from_numpy(pts), spacing)
    assert got.is_contiguous() and got.dtype == torch.float32
    want = np.asarray(jsurf.squared_edt(jnp.asarray(pts), spacing))
    np.testing.assert_array_equal(got.numpy(), want)
    ref = ndimage.distance_transform_edt(~pts, sampling=spacing) ** 2
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_squared_edt_empty_is_inf():
    got = tsurf.squared_edt(torch.zeros(4, 5, 6, dtype=torch.bool), (1.0, 2.0, 3.0))
    assert torch.isinf(got).all() and tuple(got.shape) == (4, 5, 6)


@pytest.mark.parametrize("n_true", [0, 1, 2, 7, 40])
@pytest.mark.parametrize("q", [95.0, 50.0])
def test_masked_percentile(n_true, q):
    rng = np.random.RandomState(n_true)
    values = (rng.rand(40) * 30).astype(np.float32)
    mask = np.zeros(40, bool)
    mask[rng.permutation(40)[:n_true]] = True
    got = tsurf._masked_percentile(torch.from_numpy(values), torch.from_numpy(mask), q)
    want = jsurf._masked_percentile(jnp.asarray(values), jnp.asarray(mask), q)
    _close(got.numpy(), want)
    if n_true:
        np.testing.assert_allclose(float(got), np.percentile(values[mask], q), rtol=1e-5)


def _pair(case):
    shape = (12, 14, 10)
    a, b = ball(shape, (6, 6, 5), 3), ball(shape, (7, 6, 4), 4)
    zero = np.zeros(shape, np.float32)
    return {"shifted": (a, b), "same": (a, a), "empty_pred": (zero, b),
            "empty_gt": (a, zero), "both_empty": (zero, zero)}[case]


@pytest.mark.parametrize("case", ["shifted", "same", "empty_pred", "empty_gt", "both_empty"])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("nsd_tol", [None, 1.5])
def test_surface_metrics_single(case, symmetric, nsd_tol):
    pred, gt = _pair(case)
    spacing = (3.0, 1.0, 1.0)
    want = jsurf.surface_metrics_single(jnp.asarray(pred), jnp.asarray(gt), spacing,
                                        symmetric_asd=symmetric, nsd_tol=nsd_tol)
    got = tsurf.surface_metrics_single(torch.from_numpy(pred), torch.from_numpy(gt), spacing,
                                       symmetric_asd=symmetric, nsd_tol=nsd_tol)
    assert len(got) == len(want) == (2 if nsd_tol is None else 3)
    for g, w in zip(got, want):
        assert g.dim() == 0
        _close(g.numpy(), w)
    if case == "empty_pred" and nsd_tol is not None:
        assert float(got[2]) == 0.0
    if case == "both_empty" and nsd_tol is not None:
        assert np.isinf(float(got[2]))


@pytest.mark.parametrize("nsd_tol", [None, 2.0, [1.0, 3.0]], ids=["none", "scalar", "per_region"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_batched_surface_metrics(nsd_tol, symmetric):
    shape = (10, 12, 8)
    pred = np.zeros((2,) + shape + (2,), np.float32)
    gt = np.zeros_like(pred)
    pred[0, ..., 0], gt[0, ..., 0] = ball(shape, (5, 6, 4), 3), ball(shape, (4, 6, 4), 3)
    pred[0, ..., 1], gt[0, ..., 1] = ball(shape, (5, 5, 4), 2), ball(shape, (5, 6, 3), 3)
    gt[1, ..., 0] = ball(shape, (5, 6, 4), 2)  # sample 1, region 0: empty prediction
    pred[1, ..., 1] = ball(shape, (3, 3, 3), 2)  # sample 1, region 1: empty ground truth
    spacing = (2.0, 1.0, 1.5)
    want = jsurf.batched_surface_metrics(jnp.asarray(pred), jnp.asarray(gt), spacing=spacing,
                                         symmetric_asd=symmetric, nsd_tol=nsd_tol)
    got = tsurf.batched_surface_metrics(torch.from_numpy(pred), torch.from_numpy(gt), spacing=spacing,
                                        symmetric_asd=symmetric, nsd_tol=nsd_tol)
    assert len(got) == len(want) == (2 if nsd_tol is None else 3)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 2)
        _close(g.numpy(), w)


@pytest.mark.parametrize("lead", [(3,), (2, 2)])
def test_extract_surface_takes_leading_dimensions(lead):
    m = np.random.RandomState(3).rand(*lead, 7, 9, 6) > 0.5
    got = tsurf.extract_surface(torch.from_numpy(m)).numpy()
    flat = m.reshape((-1,) + m.shape[-3:])
    for k, vol in enumerate(flat):
        np.testing.assert_array_equal(got.reshape(flat.shape)[k], np.asarray(jsurf.extract_surface(jnp.asarray(vol))))


def test_squared_edt_takes_a_stack_of_volumes():
    pts = np.random.RandomState(5).rand(3, 6, 9, 7) > 0.95
    spacing = (0.5, 2.0, 1.25)
    got = tsurf.squared_edt(torch.from_numpy(pts), spacing)
    assert tuple(got.shape) == pts.shape and got.is_contiguous()
    for k in range(3):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jsurf.squared_edt(jnp.asarray(pts[k]), spacing)))
        np.testing.assert_array_equal(got[k].numpy(), tsurf.squared_edt(torch.from_numpy(pts[k]), spacing).numpy())
    swapped = torch.from_numpy(pts).transpose(2, 3)  # not contiguous: copied, not refused
    np.testing.assert_array_equal(tsurf.squared_edt(swapped, spacing).numpy(),
                                  tsurf.squared_edt(swapped.contiguous(), spacing).numpy())


def _batch_of_pairs():
    """B = 2, R = 2: a shifted pair, an equal pair, an empty prediction, an
    empty ground truth."""
    shape = (10, 12, 8)
    pred = np.zeros((2,) + shape + (2,), np.float32)
    gt = np.zeros_like(pred)
    pred[0, ..., 0], gt[0, ..., 0] = ball(shape, (5, 6, 4), 3), ball(shape, (4, 6, 4), 3)
    pred[0, ..., 1] = gt[0, ..., 1] = ball(shape, (5, 5, 4), 2)
    gt[1, ..., 0] = ball(shape, (5, 6, 4), 2)
    pred[1, ..., 1] = ball(shape, (3, 3, 3), 2)
    return pred, gt


@pytest.mark.parametrize("nsd_tol", [None, [1.0, 3.0]], ids=["none", "per_region"])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("group_bytes", [None, 1], ids=["one_group", "a_group_per_pair"])
def test_batched_pairs_match_reference_and_single(nsd_tol, symmetric, group_bytes, monkeypatch):
    """All pairs at once against the JAX function (tolerance: ATOL, as above)
    and against the one-pair function pair by pair; with the byte budget cut
    to one pair per group the results do not change."""
    pred, gt = _batch_of_pairs()
    spacing = (2.0, 1.0, 1.5)
    kw = dict(spacing=spacing, symmetric_asd=symmetric, nsd_tol=nsd_tol)
    whole = tsurf.batched_surface_metrics(torch.from_numpy(pred), torch.from_numpy(gt), **kw)
    if group_bytes is not None:
        monkeypatch.setattr(tsurf, "_GROUP_BYTES", group_bytes)
    got = tsurf.batched_surface_metrics(torch.from_numpy(pred), torch.from_numpy(gt), **kw)
    want = jsurf.batched_surface_metrics(jnp.asarray(pred), jnp.asarray(gt), **kw)
    assert len(got) == len(want) == (2 if nsd_tol is None else 3)
    for g, w, u in zip(got, want, whole):
        assert tuple(g.shape) == (2, 2) and g.dtype == torch.float32
        _close(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), u.numpy())
    for i in range(2):
        for c in range(2):
            one = tsurf.surface_metrics_single(
                torch.from_numpy(pred[i, ..., c]), torch.from_numpy(gt[i, ..., c]), spacing,
                symmetric_asd=symmetric, nsd_tol=None if nsd_tol is None else nsd_tol[c])
            for g, o in zip(got, one):
                _close(g[i, c].numpy(), o.numpy())
    assert np.isinf(got[0][1].numpy()).all()  # one-sided empty pairs: HD95 +inf
    assert float(got[0][0, 1]) == 0.0 and float(got[1][0, 1]) == 0.0  # the equal pair
    if nsd_tol is not None:
        assert float(got[2][0, 1]) == 1.0 and float(got[2][1, 0]) == 0.0 and float(got[2][1, 1]) == 0.0


def test_both_empty_pair_in_a_batch():
    pred, gt = _batch_of_pairs()
    pred[1, ..., 0] = 0
    gt[1, ..., 0] = 0
    got = tsurf.batched_surface_metrics(torch.from_numpy(pred), torch.from_numpy(gt),
                                        spacing=(1.0, 1.0, 1.0), nsd_tol=1.0)
    want = jsurf.batched_surface_metrics(jnp.asarray(pred), jnp.asarray(gt), spacing=(1.0, 1.0, 1.0), nsd_tol=1.0)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    assert all(np.isinf(float(g[1, 0])) for g in got)


ASD_RTOL = 1e-6  # f64 distance sums rounded once, against the reference's f32 sums (a few f32 ulps)


@pytest.mark.parametrize("symmetric", [False, True])
def test_asd_sums_in_f64_against_reference(symmetric):
    """The distance sums behind ASD are taken in f64 and the mean rounded once
    to f32: within one f32 ulp of the mean computed by numpy in f64 from the
    same distance fields, and within ASD_RTOL (relative) of the reference,
    which sums in f32, at distances of tens of mm."""
    shape = (16, 40, 36)
    pred, gt = ball(shape, (5, 9, 9), 4), ball(shape, (10, 30, 26), 5)
    spacing = (3.0, 1.0, 1.0)
    got = tsurf.surface_metrics_single(torch.from_numpy(pred), torch.from_numpy(gt), spacing,
                                       symmetric_asd=symmetric)[1]
    want = jsurf.surface_metrics_single(jnp.asarray(pred), jnp.asarray(gt), spacing, symmetric_asd=symmetric)[1]
    sp = tsurf.extract_surface(torch.from_numpy(pred)).numpy()
    sg = tsurf.extract_surface(torch.from_numpy(gt)).numpy()
    d_gt = np.sqrt(tsurf.squared_edt(torch.from_numpy(sg), spacing).numpy()).astype(np.float64)
    d_pred = np.sqrt(tsurf.squared_edt(torch.from_numpy(sp), spacing).numpy()).astype(np.float64)
    exact = (d_gt[sp].sum() + d_pred[sg].sum()) / (sp.sum() + sg.sum()) if symmetric else d_gt[sp].mean()
    assert got.dtype == torch.float32 and float(got) > 20.0
    assert abs(float(got) - exact) <= np.spacing(np.float32(exact))
    np.testing.assert_allclose(float(got), float(want), rtol=ASD_RTOL, atol=0)
