"""Parity of the two options of the inference forward — flip-averaged TTA
(multimodal_tta_tpu_torch/ops/flip_tta.py) and sliding-window inference
(ops/sliding_window.py) — with the JAX ones, on a forward that both
frameworks compute alike (a fixed per-voxel map that is not
flip-equivariant). Tolerance 1e-5 absolute on f32 logits/probabilities of
order 1 (the blend's sums run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.ops import flip_tta as jflip
from multimodal_tta_tpu.ops import sliding_window as jsw
from multimodal_tta_tpu_torch.ops import flip_tta as tflip
from multimodal_tta_tpu_torch.ops import sliding_window as tsw

torch.set_num_threads(1)

ATOL = 1e-5


def _forwards(shape, k=2, seed=0):
    """logits = x[..., :1] * ramp + x[..., 1:2] - 0.3 * ramp, tiled to k
    classes: depends on position within the window, so flips and window
    offsets matter."""
    d, h, w = shape
    ramp = (np.arange(d)[:, None, None] * 0.3 + np.arange(h)[None, :, None] * 0.2
            + np.arange(w)[None, None, :] * 0.1).astype(np.float32)[None, ..., None]
    scale = np.arange(1, k + 1, dtype=np.float32)

    def jf(x):
        return (x[..., :1] * ramp + x[..., 1:2] - 0.3 * ramp) * scale

    def tf(x):
        r = torch.from_numpy(ramp)
        return (x[..., :1] * r + x[..., 1:2] - 0.3 * r) * torch.from_numpy(scale)

    return jf, tf


def test_flip_combos():
    assert tflip.flip_combos([1, 2, 3]) == jflip.flip_combos([1, 2, 3])
    assert tflip.flip_combos([2]) == ((), (2,))
    assert len(tflip.flip_combos([1, 2, 3])) == 8 and tflip.flip_combos([])[0] == ()


@pytest.mark.parametrize("axes", [(1,), (2, 3), (1, 2, 3)])
@pytest.mark.parametrize("with_variance", [False, True])
def test_flip_averaged_probs(axes, with_variance):
    shape = (4, 6, 5)
    x = np.random.RandomState(1).randn(2, *shape, 2).astype(np.float32)
    jf, tf = _forwards(shape)
    want = jflip.flip_averaged_probs(jf, jnp.asarray(x), axes, jax.nn.sigmoid, with_variance)
    got = tflip.flip_averaged_probs(tf, torch.from_numpy(x), axes, torch.sigmoid, with_variance)
    assert len(got) == len(want) == (3 if with_variance else 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    if with_variance:
        assert float(got[2].min()) >= 0.0 and float(got[2].max()) > 0.0


@pytest.mark.parametrize("size,roi,overlap", [(10, 4, 0.25), (10, 4, 0.5), (7, 7, 0.25), (5, 8, 0.0), (9, 4, 0.9)])
def test_window_starts(size, roi, overlap):
    assert tsw.window_starts(size, roi, overlap) == jsw.window_starts(size, roi, overlap)


def test_gaussian_importance():
    np.testing.assert_array_equal(tsw.gaussian_importance((4, 6, 5)), jsw.gaussian_importance((4, 6, 5)))


@pytest.mark.parametrize("mode", ["gaussian", "constant"])
@pytest.mark.parametrize("vol,roi,overlap", [
    ((8, 10, 9), (4, 6, 5), 0.25), ((8, 10, 9), (8, 10, 9), 0.25), ((3, 10, 9), (4, 6, 5), 0.5),
])
def test_sliding_window_inference(mode, vol, roi, overlap):
    x = np.random.RandomState(2).randn(2, *vol, 2).astype(np.float32)
    jf, tf = _forwards(roi)
    want = jsw.sliding_window_inference(jf, jnp.asarray(x), roi, num_classes=2, overlap=overlap, mode=mode)
    got = tsw.sliding_window_inference(tf, torch.from_numpy(x), roi, num_classes=2, overlap=overlap, mode=mode)
    assert tuple(got.shape) == (2, *vol, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_sliding_window_unknown_mode():
    _, tf = _forwards((4, 4, 4))
    with pytest.raises(ValueError, match="blend mode"):
        tsw.sliding_window_inference(tf, torch.zeros(1, 4, 4, 4, 2), (4, 4, 4), num_classes=2, mode="cubic")
