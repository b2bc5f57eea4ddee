"""Parity of the port's Dice/IoU reductions (multimodal_tta_tpu_torch/ops/
seg_metrics.py) with the JAX ones. Tolerance: 1e-6 absolute on values in
[0, 1] (f32 sums of 0/1 values are exact at this size; the divisions may
round differently); the validity and emptiness masks must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.ops.seg_metrics import binary_dice_iou as jax_binary_dice_iou
from multimodal_tta_tpu.ops.seg_metrics import dice_iou_from_logits as jax_dice_iou_from_logits
from multimodal_tta_tpu_torch.ops.seg_metrics import binary_dice_iou, dice_iou_from_logits

torch.set_num_threads(1)


def _masks(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    pred = (rng.rand(3, 5, 6, 7, 2) > 0.5).astype(dtype)
    gt = (rng.rand(3, 5, 6, 7, 2) > 0.6).astype(dtype)
    gt[1, ..., 0] = 0  # an empty ground truth: invalid
    pred[2, ..., 1] = 0  # an empty prediction
    return pred, gt


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_binary_dice_iou(dtype):
    pred, gt = _masks(0, dtype)
    want = jax_binary_dice_iou(jnp.asarray(pred), jnp.asarray(gt))
    got = binary_dice_iou(torch.from_numpy(pred), torch.from_numpy(gt))
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.float32 and tuple(g.shape) == (3, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    assert got[2].dtype == torch.bool
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert not got[2][1, 0]


@pytest.mark.parametrize("threshold", [0.3, 0.5])
def test_dice_iou_from_logits(threshold):
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 4, 5, 6, 3) * 2).astype(np.float32)
    logits[0, ..., 2] = -9.0  # empty prediction
    gt = (rng.rand(2, 4, 5, 6, 3) > 0.5).astype(np.float32)
    want = jax_dice_iou_from_logits(jnp.asarray(logits), jnp.asarray(gt), threshold)
    got = dice_iou_from_logits(torch.from_numpy(logits), torch.from_numpy(gt), threshold)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3][0, 2]
