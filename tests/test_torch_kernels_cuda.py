"""The port's hand-written kernels against their plain PyTorch versions on
the card. Every test here is marked ``cuda`` and skips without a GPU (the
Triton kernels have no CPU or interpret mode). The card's machine has no
JAX, so this file imports none; run it there without the JAX test setup:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda
"""

import pytest
import torch

from multimodal_tta_tpu_torch.kernels.fused_instance_norm import (
    fused_instance_norm,
    instance_norm_plain,
)

# f32: other summation order; bf16: one rounding step of the output
TOLS = {torch.float32: (5e-5, 0.0), torch.bfloat16: (5e-2, 2.0 ** -7)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Triton kernel has no CPU or interpret mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 18, 18, 128), (1, 3, 5, 7, 48), (2, 3, 9, 9, 512)])
@pytest.mark.parametrize("act", ["relu", None])
def test_fused_instance_norm_matches_plain(dtype, shape, act):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device="cuda") * 3 + 1).to(dtype)
    gamma = torch.rand(c, generator=g, device="cuda") + 0.5
    beta = torch.randn(c, generator=g, device="cuda") * 0.1
    before = fused_instance_norm.launches
    got = fused_instance_norm(x, gamma, beta, act=act)
    torch.cuda.synchronize()
    assert fused_instance_norm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = instance_norm_plain(x, gamma, beta, act=act)
    atol, rtol = TOLS[dtype]
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), float(err.max())


@pytest.mark.cuda
def test_fused_instance_norm_rejects_what_the_kernel_does_not_take():
    _need_card()
    x = torch.randn(1, 2, 4, 4, 8, device="cuda")
    gamma = torch.ones(8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        fused_instance_norm(x.transpose(1, 2), gamma, gamma)
    with pytest.raises(ValueError, match="gamma"):
        fused_instance_norm(x, gamma.double(), gamma)
    with pytest.raises(TypeError):
        fused_instance_norm(x.double(), gamma, gamma)
