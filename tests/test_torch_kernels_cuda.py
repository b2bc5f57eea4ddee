"""The port's hand-written kernels against their plain PyTorch versions on
the card. Every test here is marked ``cuda`` and skips without a GPU (the
Triton and CUDA kernels have no CPU or interpret mode). The card's machine has no
JAX, so this file imports none; run it there without the JAX test setup:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda
"""

import pytest
import torch

from multimodal_tta_tpu_torch.kernels.edt_minplus import minplus, minplus_plain
from multimodal_tta_tpu_torch.kernels.fused_instance_norm import (
    fused_instance_norm,
    instance_norm_plain,
)

# f32: other summation order; bf16: one rounding step of the output
TOLS = {torch.float32: (5e-5, 0.0), torch.bfloat16: (5e-2, 2.0 ** -7)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")


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


def _cost(n, spacing):
    i = torch.arange(n, dtype=torch.float32, device="cuda")
    return ((i[None, :] - i[:, None]) * spacing) ** 2


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(20736, 48), (6912, 144), (10, 48), (300, 144), (256, 128),
                                    (1, 7), (65, 65), (1000, 300)])
@pytest.mark.parametrize("fill", ["sparse", "finite", "all_inf"])
def test_minplus_is_bitwise_the_plain_version(rows, n, fill):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(rows + n)
    if fill == "sparse":
        f = torch.where(torch.rand(rows, n, generator=g, device="cuda") > 0.85, 0.0, float("inf"))
    elif fill == "finite":
        f = torch.rand(rows, n, generator=g, device="cuda") * 50
    else:
        f = torch.full((rows, n), float("inf"), device="cuda")
    cost = _cost(n, 1.5)
    before = minplus.launches
    got = minplus(f, cost)
    torch.cuda.synchronize()
    assert minplus.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == f.shape and got.is_contiguous()
    assert not torch.isnan(got).any()
    assert torch.equal(got, minplus_plain(f, cost))
    if fill == "all_inf":
        assert torch.isinf(got).all()


@pytest.mark.cuda
def test_minplus_runs_on_the_current_stream():
    _need_card()
    f = torch.rand(512, 96, device="cuda")
    cost = _cost(96, 1.0)
    want = minplus_plain(f, cost)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = minplus(f, cost)
    side.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_minplus_rejects_what_the_kernel_does_not_take():
    _need_card()
    f = torch.zeros(6, 8, device="cuda")
    cost = torch.zeros(8, 8, device="cuda")
    with pytest.raises(TypeError, match="minplus"):
        minplus(f.double(), cost)
    with pytest.raises(ValueError, match="contiguous"):
        minplus(torch.zeros(8, 6, device="cuda").t(), cost)
    with pytest.raises(ValueError, match="cost"):
        minplus(f, cost.cpu())
    with pytest.raises(ValueError, match="cost"):
        minplus(f, torch.zeros(8, 7, device="cuda"))
