"""Parity of the port's deep supervision (``UNet3D(deep_supervision=k)``
and its loss in ``SegTrainer``) with the flax model and the JAX trainer, on
the same params (``models/convert.py:from_flax``) and seeded inputs.

  - the ``ds_head{i}`` logits against flax's sown ``ds1``/``ds2``, f32,
    max abs 1e-4 (the main logits' bound in tests/test_torch_unet3d.py),
    remat off and on; no head runs outside a training forward that
    captures, and the heads exist from construction (82 + 4 tensors on
    the flagship with k=2, as flax's init creates them);
  - ``SegTrainer`` steps with ``model.deep_supervision=2`` (weights 4/7,
    2/7, 1/7 on labels sliced ``::2`` / ``::4``; SGD), remat off and on:
    the losses and params to ``tests/test_torch_seg_trainer.py``'s
    tolerances;
  - the misuse on ``unet_ws`` (no heads) raises the reference's
    ``ValueError``; Tent adapts the tensors the reference selects.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu.models.unet3d_ws import UNet3DWS as JaxUNet3DWS
from multimodal_tta_tpu.tta.tent import norm_param_mask as jax_norm_param_mask
from multimodal_tta_tpu_torch.models.convert import from_flax
from multimodal_tta_tpu_torch.models.layers import capture_intermediates
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.models.unet3d_ws import UNet3DWS
from multimodal_tta_tpu_torch.tta.tent import norm_param_mask
from tests._torch_port import (SGD, SMALL_SHAPE, flat_flax, meta_model, random_flax_params, trainer_config,
                               trainer_pair, assert_steps_match)
from tests.test_torch_seg_trainer import make_volumes

torch.set_num_threads(2)

# three levels, so that k=2 supervises R/2 and R/4 of the [8,16,16] volumes
DS3 = dict(in_channels=2, num_classes=1, channels=(4, 8, 16, 32), strides=(2, 2, 2), num_res_units=2)


@pytest.mark.parametrize("remat", [False, True])
def test_heads_match_the_sown_logits(remat):
    jm = JaxUNet3D(**DS3, deep_supervision=2, remat=remat)
    params = random_flax_params(jm, (1,) + SMALL_SHAPE, seed=3)
    assert {"ds_head1", "ds_head2"} <= set(params) and "ds_head3" not in params
    tm = UNet3D(**DS3, deep_supervision=2, remat=remat, device="cpu")
    tm.load_state_dict(from_flax(params), strict=True)
    x = np.random.RandomState(4).randn(2, *SMALL_SHAPE).astype(np.float32)
    want, inter = jm.apply({"params": params}, jnp.asarray(x), train=True, mutable=["intermediates"])
    tm.train()
    with capture_intermediates() as got_inter:
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    for i, shape in ((1, (2, 4, 8, 8, 1)), (2, (2, 2, 4, 4, 1))):
        ref = np.asarray(inter["intermediates"][f"ds{i}"][0])
        assert len(got_inter[f"ds{i}"]) == 1 and ref.shape == shape
        np.testing.assert_allclose(got_inter[f"ds{i}"][0].detach().numpy(), ref, atol=1e-4)
    # a head's gradient reaches its conv
    got_inter["ds2"][0].sum().backward()
    assert float(tm.ds_head2.weight.grad.abs().sum()) > 0.0
    # no head outside a capturing training forward: eval, or training without a capture
    for training, capture in ((False, True), (True, False)):
        tm.train(training)
        with capture_intermediates(capture) as none, torch.no_grad():
            tm(torch.from_numpy(x))
        assert none == {}


def test_flagship_param_tree_and_tent_mask():
    m = meta_model("unet", {"deep_supervision": 2})
    names = [n for n, _ in m.named_parameters()]
    assert len(names) == 86 and {"ds_head1.weight", "ds_head2.bias"} <= set(names)
    assert m.ds_head1.weight.shape == (1, 64, 1, 1, 1) and m.ds_head2.weight.shape == (1, 128, 1, 1, 1)
    # 4 strided levels: k is capped at 3 heads (R/2..R/8), as flax's min(k, n_levels - 1)
    assert meta_model("unet", {"deep_supervision": 9}).ds_levels == 3
    jm = JaxUNet3D(**DS3, deep_supervision=2)
    params = random_flax_params(jm, (1,) + SMALL_SHAPE, seed=3)
    tm = UNet3D(**DS3, deep_supervision=2, device="cpu")
    n_jax = sum(jax.tree_util.tree_leaves(jax_norm_param_mask(params)))
    assert sum(norm_param_mask(tm).values()) == n_jax == 2 * 2 * 7
    assert len(flat_flax(params)) == len(list(tm.parameters()))


@pytest.mark.parametrize("remat", [False, True])
def test_segtrainer_steps_with_deep_supervision(remat):
    jm = JaxUNet3D(**DS3, deep_supervision=2, remat=remat)
    tm = UNet3D(**DS3, deep_supervision=2, remat=remat, device="cpu")
    params = random_flax_params(jm, (1,) + SMALL_SHAPE, seed=5)
    cfg = trainer_config(SGD, {"deep_supervision": 2, "strides": list(DS3["strides"])})
    jt, pt = trainer_pair(cfg, jm, tm, params)
    assert pt.ds_factors == [2, 4] and pt.ds_weights == pytest.approx([4 / 7, 2 / 7, 1 / 7], rel=1e-15)
    img, lbl = make_volumes(4, seed=13)
    batches = [{"image": img[i:i + 2], "label": lbl[i:i + 2]} for i in (0, 2)]
    losses = assert_steps_match(jt, pt, batches, f"deep supervision remat={remat}")
    assert np.isfinite(losses).all()
    moved = [n for n, p in tm.named_parameters() if n.startswith("ds_head") and p.grad is not None]
    assert sorted(moved) == ["ds_head1.bias", "ds_head1.weight", "ds_head2.bias", "ds_head2.weight"]


def test_deep_supervision_on_unet_ws_raises_the_reference_error():
    kw = dict(in_channels=2, num_classes=1, channels=(4, 8, 16), strides=(2, 2), num_res_units=1)
    jm = JaxUNet3DWS(**kw)
    tm = UNet3DWS(**kw, device="cpu")
    params = random_flax_params(jm, (1,) + SMALL_SHAPE, seed=6)
    jt, pt = trainer_pair(trainer_config(SGD, {"deep_supervision": 1}), jm, tm, params)
    img, lbl = make_volumes(2, seed=14)
    raised = []
    for trainer in (jt, pt):
        with pytest.raises(ValueError) as err:
            trainer.run_step({"image": img, "label": lbl})
        raised.append(str(err.value))
    assert raised[0] == raised[1] and "sowed no ['ds1']" in raised[1]
