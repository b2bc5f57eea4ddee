"""Parity of the port's SSIM / MS-SSIM (multimodal_tta_tpu_torch/ops/ssim.py)
with the JAX ones (multimodal_tta_tpu/ops/ssim.py) on the same seeded inputs,
2D ([B, H, W, C]) and 3D ([B, D, H, W, C]): within 1e-5 (f32 convolutions
and means summed in another order)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules (each package's ops/__init__.py exports the function ``ssim``)
jssim = importlib.import_module("multimodal_tta_tpu.ops.ssim")
tssim = importlib.import_module("multimodal_tta_tpu_torch.ops.ssim")

TOL = 1e-5


def _pair(shape, seed, noise=0.15):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    return x, np.clip(x + noise * rng.randn(*shape), 0, 1).astype(np.float32)


CASES = {
    "2d": ((2, 40, 36, 3), {}),
    "3d": ((2, 20, 24, 22, 2), {}),
    "3d_range": ((1, 16, 18, 17, 1), {"data_range": 255.0, "win_size": 7, "win_sigma": 1.0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssim_matches_reference(case):
    """Per sample and averaged (the JAX per-sample values, once)."""
    shape, kw = CASES[case]
    x, y = _pair(shape, 0)
    if kw.get("data_range") == 255.0:
        x, y = x * 255, y * 255
    want = np.asarray(jssim.ssim(jnp.asarray(x), jnp.asarray(y), size_average=False, **kw))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = tssim.ssim(tx, ty, size_average=False, **kw)
    assert tuple(got.shape) == want.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(float(tssim.ssim(tx, ty, **kw)), float(np.mean(want)), rtol=0, atol=TOL)
    assert torch.equal(tssim.SSIM(**kw)(tx, ty), tssim.ssim(tx, ty, **kw))


MS_CASES = {
    "2d_5_scales": ((2, 200, 196, 1), {}),
    "2d_3_scales": ((1, 60, 64, 3), {"weights": (0.2, 0.3, 0.5)}),
    "3d_3_scales": ((1, 48, 50, 52, 1), {"weights": (0.0448, 0.2856, 0.3001)}),
}


@pytest.mark.parametrize("case", sorted(MS_CASES))
def test_ms_ssim_matches_reference(case):
    shape, kw = MS_CASES[case]
    x, y = _pair(shape, 1, noise=0.05)
    want = np.asarray(jssim.ms_ssim(jnp.asarray(x), jnp.asarray(y), size_average=False, **kw))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = tssim.ms_ssim(tx, ty, size_average=False, **kw)
    assert tuple(got.shape) == want.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(float(tssim.ms_ssim(tx, ty, **kw)), float(np.mean(want)), rtol=0, atol=TOL)
    assert torch.equal(tssim.MS_SSIM(**kw)(tx, ty), tssim.ms_ssim(tx, ty, **kw))


def test_identical_inputs_and_errors():
    x, _ = _pair((1, 24, 24, 2), 2)
    t = torch.from_numpy(x)
    assert abs(float(tssim.ssim(t, t)) - 1.0) < 1e-6
    with pytest.raises(ValueError, match="shape mismatch"):
        tssim.ssim(t, t[:, :20])
    with pytest.raises(ValueError, match="expects"):
        tssim.ssim(t[0], t[0])
    with pytest.raises(ValueError, match="too small for 5 scales"):
        tssim.ms_ssim(t, t)
