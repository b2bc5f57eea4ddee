"""Parity of the port's UNet3D with the flax model: logits at the dryrun
size from the same weights, the flagship's parameter tree, and the device
rule of the port's entry points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.models.convert import unet3d_from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.registry import get_model
from multimodal_tta_tpu_torch.tta.tent import norm_param_mask
from tests._torch_port import DRYRUN, load_flax, np_params, randomize

torch.set_num_threads(1)

FLAGSHIP = dict(in_channels=2, num_classes=1, channels=(32, 64, 128, 256, 512),
                strides=(2, 2, 2, 2), num_res_units=2)


def _logits(jdtype, tdtype, seed=0):
    x = (np.random.RandomState(seed).randn(1, 16, 16, 16, 2)).astype(np.float32)
    jm = JaxUNet3D(**DRYRUN, dtype=jdtype)
    params = randomize(np_params(jm, x, train=False), seed + 1)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), train=False))
    tm = load_flax(UNet3D(**DRYRUN, dtype=tdtype, device="cpu"), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, 16, 16, 16, 1)
    return got.numpy(), want


def test_logits_f32():
    got, want = _logits(jnp.float32, torch.float32)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_logits_bf16():
    """bf16 compute in both: convs round at other places in XLA and oneDNN,
    and 18 norms re-amplify each rounding, so the bound is loose — relative
    L2 5e-2, stated before the run (a bf16 ulp is 7.8e-3)."""
    got, want = _logits(jnp.bfloat16, torch.bfloat16, seed=2)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 5e-2, rel


def test_flagship_tree_matches_flax():
    """82 parameter tensors, 36 of them norm affines, with the flax tree's
    names and shapes (carried by convert.py)."""
    x = jax.ShapeDtypeStruct((1, 16, 16, 16, 2), jnp.float32)
    shapes = jax.eval_shape(
        lambda: JaxUNet3D(**FLAGSHIP).init(jax.random.PRNGKey(0), jnp.zeros(x.shape), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    want = {k: tuple(v.shape) for k, v in unet3d_from_flax(zeros).items()}
    tm = UNet3D(**FLAGSHIP, dtype=torch.bfloat16, device="cpu")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert len(got) == 82
    assert sum(norm_param_mask(tm).values()) == 36


def test_init_follows_flax_defaults():
    tm = UNet3D(**DRYRUN, device="cpu", seed=5)
    w = tm.enc1.unit0.conv.weight.detach()  # fan_in = 27 * 4
    sd = (1.0 / 108) ** 0.5
    assert abs(float(w.std()) - sd) < 0.15 * sd
    assert float(w.abs().max()) <= 2 * sd / 0.87962566103423978 + 1e-6
    assert float(tm.enc1.residual_proj.bias.detach().abs().max()) == 0.0
    assert torch.equal(tm.enc1.unit0.n.norm.scale, torch.ones(8))
    again = UNet3D(**DRYRUN, device="cpu", seed=5)
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(), again.parameters()))


def test_conv_weights_are_channels_last():
    tm = UNet3D(**DRYRUN, device="cpu")
    assert tm.dec0.unit0.conv.weight.is_contiguous(memory_format=torch.channels_last_3d)


def test_from_config_and_registry():
    cfg = ConfigNode({"in_channels": 2, "num_classes": 1, "channels": [4, 8, 16, 32, 64],
                      "strides": [2, 2, 2, 2], "num_res_units": 2})
    m = get_model("unet").from_config(cfg, device="cpu")
    assert isinstance(m, UNet3D) and m.channels == (4, 8, 16, 32, 64)


@pytest.mark.parametrize("kw", [{"remat": True}, {"deep_supervision": 1}, {"moe_experts": 2},
                                {"dropout": 0.1}])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        UNet3D(**{**DRYRUN, **kw}, device="cpu")


def test_entry_point_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UNet3D(**DRYRUN)
    UNet3D(**DRYRUN, device="cpu")


def test_input_validation():
    tm = UNet3D(**DRYRUN, device="cpu")
    with pytest.raises(ValueError, match="input channels"):
        tm(torch.zeros(1, 16, 16, 16, 3))
    with pytest.raises(ValueError, match="divisible"):
        tm(torch.zeros(1, 16, 16, 12, 2))
