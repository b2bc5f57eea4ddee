"""The port's min-plus line transform (multimodal_tta_tpu_torch/kernels/
edt_minplus.py) on the CPU, where the wrapper takes its plain version:
against the Pallas kernel in interpret mode and against the numpy oracle, at
the cases of tests/test_pallas_kernels.py.

Tolerance: none. Every candidate is one f32 add and a min is exact in any
order, so all three must agree bitwise, +inf included.

Also pinned here, without a card: the launch plan of the CUDA kernels
(``plan``, ``plan_volumes``: warp shape, tile rows, shared memory, and that the
tiles and line addresses cover every element of a volume exactly once), the
kernel's cost table against the reference's cost matrix, and the plain
version of ``squared_edt_volumes`` against the JAX ``squared_edt``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.ops import surface as jsurf
from multimodal_tta_tpu.pallas.edt_minplus import minplus_pallas
from multimodal_tta_tpu_torch.kernels import edt_minplus as K
from multimodal_tta_tpu_torch.kernels.edt_minplus import (
    minplus,
    minplus_plain,
    plan,
    plan_tiles,
    plan_volumes,
    squared_edt_volumes,
    squared_edt_volumes_plain,
)

torch.set_num_threads(1)


def oracle(f, cost):
    return np.min(f[:, :, None] + cost[None, :, :], axis=1)


def _cost(n, spacing):
    i = np.arange(n, dtype=np.float32)
    return ((i[None, :] - i[:, None]) * np.float32(spacing)) ** 2


def _case(name):
    if name == "all_inf":
        return np.full((4, 16), np.inf, np.float32), _cost(16, 1.0)
    if name == "finite":
        f = (np.random.RandomState(9).rand(20, 32) * 50).astype(np.float32)
        return f, _cost(32, 3.0)
    rows, n = name
    rng = np.random.RandomState(rows + n)
    f = np.where(rng.rand(rows, n) > 0.85, 0.0, np.inf).astype(np.float32)
    return f, _cost(n, 1.5)


CASES = [(10, 48), (300, 144), (256, 128), (1, 7), (513, 5), "all_inf", "finite"]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_pallas_and_oracle(case):
    f, cost = _case(case)
    before = minplus.launches
    got = minplus(torch.from_numpy(f), torch.from_numpy(cost)).numpy()
    assert minplus.launches == before  # a CPU tensor launches no kernel
    assert got.dtype == np.float32 and got.shape == f.shape
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got, oracle(f, cost))
    want = np.asarray(minplus_pallas(jnp.asarray(f), jnp.asarray(cost), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        minplus_plain(torch.from_numpy(f), torch.from_numpy(cost)).numpy(), got)


def test_all_inf_rows_stay_inf():
    f, cost = _case("all_inf")
    assert np.isinf(minplus(torch.from_numpy(f), torch.from_numpy(cost)).numpy()).all()


@pytest.mark.parametrize("bad,exc", [
    ("f_dtype", TypeError), ("cost_dtype", TypeError), ("cost_shape", ValueError),
    ("f_ndim", ValueError), ("f_strided", ValueError), ("cost_strided", ValueError),
    ("no_rows", ValueError), ("no_cols", ValueError),
])
def test_wrapper_rejects(bad, exc):
    f = torch.zeros(6, 8)
    cost = torch.zeros(8, 8)
    args = {
        "f_dtype": (f.double(), cost), "cost_dtype": (f, cost.double()),
        "cost_shape": (f, torch.zeros(8, 7)), "f_ndim": (torch.zeros(2, 3, 8), cost),
        "f_strided": (torch.zeros(8, 6).t(), cost), "cost_strided": (f, torch.zeros(8, 16)[:, ::2]),
        "no_rows": (torch.zeros(0, 8), cost), "no_cols": (torch.zeros(6, 0), torch.zeros(0, 0)),
    }[bad]
    with pytest.raises(exc, match="minplus"):
        minplus(*args)
    with pytest.raises(exc, match="minplus"):
        minplus_plain(*args)


def test_build_without_a_compiler_raises(monkeypatch):
    """No nvcc: building raises and nothing falls back (the kernel's plain
    version is reached only through a CPU tensor)."""
    from multimodal_tta_tpu_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda path: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    monkeypatch.undo()
    assert _build.os.path.isfile(_build.os.path.join(_build.CSRC_DIR, "edt_minplus.cu"))
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# ---- the launch plan ---------------------------------------------------------

SMEM_OPTIN, SMS = 232448, 132  # an H100: 227 KB a block may opt in to, 132 SMs


def _check_pass(p, lines, n, stride):
    cols = K.WARP_COLS
    assert (K.WARP_ROWS, K.WARP_COLS) == (32, 48) and p.row_groups >= 1
    assert p.rows == p.row_groups * K.WARP_ROWS
    assert p.np_ % cols == 0 and n <= p.np_ < n + cols
    assert p.nj % 4 == 0 and n <= p.nj < n + 4
    assert p.smem_bytes == K.pass_smem_bytes(n, p.row_groups, p.cost) <= K.MAX_SMEM_OPTIN
    assert (p.lines, p.n, p.jstride) == (lines, n, stride)
    assert p.kind == ("contiguous" if stride == 1 else "strided")
    assert p.vec == ((n if stride == 1 else stride) % 4 == 0)
    tiles = list(plan_tiles(p))
    assert len(tiles) == p.tiles and tiles[0][0] == 0 and tiles[-1][1] == lines
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))  # every line exactly once
    assert all(0 < stop - start <= p.rows for start, stop in tiles)


@pytest.mark.parametrize("axis", [0, 1, 2], ids=["D", "H", "W"])
@pytest.mark.parametrize("n", [48, 144, 155, 240, 7, 1])
def test_plan_covers_every_element_once(n, axis):
    shape = [2, 6, 8, 12]
    shape[1 + axis] = n
    v, d, h, w = shape
    vp = plan_volumes(v, d, h, w, SMEM_OPTIN, SMS)
    assert vp.threads % 32 == 0 and 32 <= vp.threads <= 32 * K.MAX_WARPS
    assert vp.smem_bytes == max(p.smem_bytes for p in vp.passes)
    strides = (h * w, w, 1)
    sizes = (d, h, w)
    for ax, p in enumerate(vp.passes):
        _check_pass(p, v * d * h * w // sizes[ax], sizes[ax], strides[ax])
        assert p.cost == "table"
        # the addresses the kernel derives: every element of [V,D,H,W] exactly once,
        # and a line is the volume's line along this axis
        base = np.array([p.line_base(rho) for rho in range(p.lines)])
        at = base[:, None] + np.arange(p.n)[None, :] * p.jstride
        assert sorted(at.reshape(-1).tolist()) == list(range(v * d * h * w))
        vol = np.arange(v * d * h * w).reshape(v, d, h, w)
        want = np.moveaxis(vol, 1 + ax, -1).reshape(-1, sizes[ax])
        assert sorted(map(tuple, at.tolist())) == sorted(map(tuple, want.tolist()))


def test_plan_of_the_evaluation_path():
    """Four HECKTOR21 surfaces: warps of 32 rows x 48 columns waste no column
    at n = 48 and n = 144, and the tiles are small enough to spread evenly."""
    vp = plan_volumes(4, 48, 144, 144, SMEM_OPTIN, SMS)
    assert vp.threads == 96 and vp.tiles == 864
    for p in vp.passes:
        assert p.np_ == p.n and p.nj == p.n and p.vec
        assert p.tiles == 864
    assert [p.rows for p in vp.passes] == [96, 32, 32]
    one = plan(6912, 144, 1, SMEM_OPTIN, SMS, cost="matrix")
    assert (one.cost, one.kind, one.warps, one.rows) == ("matrix", "contiguous", 3, 32)
    assert one.smem_bytes == 8 * 32 + 4 * 144 * 36  # row bases and the tile: the matrix stays in device memory
    assert not plan(100, 155, 1, SMEM_OPTIN, SMS).vec
    assert not plan(100, 48, 1, SMEM_OPTIN, SMS, aligned=False).vec


@pytest.mark.parametrize("args,match", [
    ((0, 8, 1), "positive"), ((8, 0, 1), "positive"), ((8, 8, 0), "positive"), ((8, 4000, 1), "shared memory"),
])
def test_plan_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        plan(*args, SMEM_OPTIN, SMS)
    with pytest.raises(ValueError, match="cost"):
        plan(8, 8, 1, SMEM_OPTIN, SMS, cost="other")


@pytest.mark.parametrize("spacing", [3.0, 1.0, 0.5, 2.0, 1.25, 0.97])
@pytest.mark.parametrize("n", [1, 7, 48, 155])
def test_cost_table_is_the_reference_cost_matrix(n, spacing):
    """d2[|i - j|] with d2[k] = (k * s) * (k * s), each product rounded to f32,
    is bitwise the matrix ((i - j) * s) ** 2 of the reference; and the
    kernel's padded table, indexed as its inner loop does, stays in range."""
    i = jnp.arange(n, dtype=jnp.float32)
    want = np.asarray(((i[None, :] - i[:, None]) * spacing) ** 2)  # multimodal_tta_tpu/ops/surface.py:76-77
    d2 = K.edt_cost_table(n, spacing).numpy()
    idx = np.abs(np.arange(n)[None, :] - np.arange(n)[:, None])
    np.testing.assert_array_equal(d2[idx], want)
    np.testing.assert_array_equal(K.edt_cost_matrix(n, spacing).numpy(), want)
    nj, np_ = -(-n // 4) * 4, -(-n // K.WARP_COLS) * K.WARP_COLS
    off = nj - 1  # table[off + i - j]
    for i0 in range(0, np_, K.THREAD_COLS):
        for j0 in range(0, nj, 4):
            start = off + i0 - j0 - 3  # the window of K.THREAD_COLS + 4 floats the loop reads
            assert start % 2 == 0 and 0 <= start and start + K.THREAD_COLS + 4 <= nj + np_


# ---- squared_edt_volumes on the CPU -----------------------------------------


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("v", [1, 3])
@pytest.mark.parametrize("spacing", [(3.0, 1.0, 1.0), (0.5, 2.0, 1.25)])
def test_squared_edt_volumes_matches_reference(v, sqrt, spacing):
    pts = np.random.RandomState(v).rand(v, 9, 14, 11) > 0.97
    if v > 1:
        pts[1] = False  # a volume without points
    before = minplus.launches
    got = squared_edt_volumes(torch.from_numpy(pts), spacing, sqrt=sqrt)
    assert minplus.launches == before  # a CPU tensor launches no kernel
    assert got.dtype == torch.float32 and tuple(got.shape) == pts.shape and got.is_contiguous()
    for k in range(v):
        want = jsurf.squared_edt(jnp.asarray(pts[k]), spacing)
        want = np.asarray(jnp.sqrt(want) if sqrt else want)
        np.testing.assert_array_equal(got[k].numpy(), want)
    if v > 1:
        assert np.isinf(got[1].numpy()).all()
    np.testing.assert_array_equal(
        squared_edt_volumes_plain(torch.from_numpy(pts), spacing, sqrt=sqrt).numpy(), got.numpy())
    as_float = squared_edt_volumes(torch.from_numpy(pts.astype(np.float32)), spacing, sqrt=sqrt)
    np.testing.assert_array_equal(as_float.numpy(), got.numpy())


@pytest.mark.parametrize("bad,match", [
    ("ndim", "V, D, H, W"), ("empty", "V, D, H, W"), ("strided", "contiguous"),
    ("spacing_len", "spacing"), ("spacing_zero", "spacing"), ("spacing_inf", "spacing"),
])
def test_squared_edt_volumes_rejects(bad, match):
    pts = torch.zeros(2, 3, 4, 5, dtype=torch.bool)
    args = {
        "ndim": (pts[0], (1, 1, 1)), "empty": (pts[:0], (1, 1, 1)), "strided": (pts.transpose(2, 3), (1, 1, 1)),
        "spacing_len": (pts, (1, 1)), "spacing_zero": (pts, (1, 0, 1)), "spacing_inf": (pts, (1, float("inf"), 1)),
    }[bad]
    with pytest.raises(ValueError, match=match):
        squared_edt_volumes(*args)
    with pytest.raises(ValueError, match=match):
        squared_edt_volumes_plain(*args)
