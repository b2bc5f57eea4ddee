"""The port's min-plus line transform (multimodal_tta_tpu_torch/kernels/
edt_minplus.py) on the CPU, where the wrapper takes its plain version:
against the Pallas kernel in interpret mode and against the numpy oracle, at
the cases of tests/test_pallas_kernels.py.

Tolerance: none. Every candidate is one f32 add and a min is exact in any
order, so all three must agree bitwise, +inf included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.pallas.edt_minplus import minplus_pallas
from multimodal_tta_tpu_torch.kernels.edt_minplus import minplus, minplus_plain

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
