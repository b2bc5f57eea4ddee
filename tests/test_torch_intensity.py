"""Parity of the port's on-device intensity normalization
(multimodal_tta_tpu_torch/ops/intensity.py) with the JAX one, applied per
sample as the JAX Tent step does (jax.vmap)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.ops import intensity as ji
from multimodal_tta_tpu_torch.ops import intensity as ti
from tests._torch_port import HECKTOR_POLICY

torch.set_num_threads(1)

ATOL = 1e-5


def _hecktor_batch(seed=0):
    """[3, 6, 10, 10, 2] CT/PET: sample 1's PET has only 5 voxels above
    mask_gt=0 (< min_count=16), so that channel falls back to whole-volume
    statistics while the others use the masked ones."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(3, 6, 10, 10, 2) * 100).astype(np.float32)
    x[..., 0] -= 600.0  # some CT below the -900 mask threshold
    pet = -np.abs(rng.randn(6, 10, 10)).astype(np.float32)
    pet.reshape(-1)[:5] = [1.0, 2.0, 3.0, 4.0, 20.0]
    x[1, ..., 1] = pet
    return x


def _compare(jfn, tfn, x):
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(x)))
    got = tfn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
    return got


def test_hecktor_policy_per_sample_with_min_count_fallback():
    kw = dict(normalize=True, intensity_policy=HECKTOR_POLICY, channel_names=["ct", "pt"])
    x = _hecktor_batch()
    got = _compare(ji.make_intensity_normalizer(**kw), ti.make_intensity_normalizer(**kw), x)
    # the fallback channel really took whole-volume stats: mean 0, sd 1
    pet = got[1, ..., 1]
    assert abs(pet.mean()) < 1e-5 and abs(pet.std() - 1.0) < 1e-4


def test_zscore_masked_direct():
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 8, 8) * 5).astype(np.float32)
    for mask_gt, min_count in ((0.0, 16), (12.0, 16), (0.0, 10**6)):
        want = np.asarray(ji.zscore_masked(jnp.asarray(x), mask_gt, 1e-6, min_count))
        got = ti.zscore_masked(torch.from_numpy(x), mask_gt, 1e-6, min_count).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_unmasked_zscore_and_channel_names_from_policy():
    policy = {"enabled": True, "channel_names": ["a", "b"],
              "channels": {"a": {"zscore": {"masked": False}}, "b": {"clip": [-1.0, 1.0]}}}
    kw = dict(normalize=True, intensity_policy=policy)
    x = (np.random.RandomState(2).randn(2, 4, 4, 4, 2) * 3 + 2).astype(np.float32)
    _compare(ji.make_intensity_normalizer(**kw), ti.make_intensity_normalizer(**kw), x)


@pytest.mark.parametrize("mean,std", [(None, None), ([10.0], [4.0]), ([1.0, -2.0], [2.0, 0.5])])
def test_legacy_mean_std(mean, std):
    kw = dict(normalize=True, mean=mean, std=std)
    x = np.random.RandomState(3).randn(2, 3, 3, 3, 2).astype(np.float32)
    _compare(ji.make_intensity_normalizer(**kw), ti.make_intensity_normalizer(**kw), x)


def test_identity_and_channel_count_check():
    x = torch.randn(1, 2, 2, 2, 3)
    assert ti.make_intensity_normalizer(normalize=False)(x) is x
    norm = ti.make_intensity_normalizer(normalize=True, intensity_policy=HECKTOR_POLICY,
                                        channel_names=["ct", "pt"])
    with pytest.raises(ValueError, match="channel_names"):
        norm(x)
