"""The port's hand-written kernels against their plain PyTorch versions on
the card. Every test here is marked ``cuda`` and skips without a GPU (the
CUDA kernels have no CPU or interpret mode). The card's machine has no
JAX, so this file imports none; run it there without the JAX test setup:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda
"""

import pytest
import torch

from multimodal_tta_tpu_torch.kernels.edt_minplus import (
    minplus,
    minplus_plain,
    squared_edt_volumes,
    squared_edt_volumes_plain,
)
from multimodal_tta_tpu_torch.kernels.fused_instance_norm import (
    _plain_forward,
    fused_instance_norm,
    instance_norm_backward,
    instance_norm_backward_plain,
    instance_norm_forward,
    instance_norm_plain,
    plan_for,
)

# f32: other summation order; bf16: one rounding step of the output
TOLS = {torch.float32: (5e-5, 0.0), torch.bfloat16: (5e-2, 2.0 ** -7)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 18, 18, 128), (1, 3, 5, 7, 48), (2, 3, 9, 9, 512),
                                   (2, 12, 36, 36, 64), (2, 24, 72, 72, 32), (2, 3, 5, 7, 7),
                                   (3, 4, 5, 6, 8)])
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


# (shape, regime and cluster the plan must take in bf16): every regime of the kernels
NORM_CASES = [((2, 3, 9, 9, 512), ("resident", 1)), ((2, 6, 18, 18, 128), ("resident", 8)),
              ((2, 12, 36, 36, 64), ("resident", 8)), ((2, 24, 72, 72, 32), ("streaming", 1)),
              ((2, 3, 5, 7, 7), ("streaming", 1))]


def _norm_case(shape, dtype, seed=0):
    """x, gamma, beta, gy on the card, with x kept off the ReLU's kink: there
    the mask depends on the summation order of the statistics."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    gamma = torch.rand(c, generator=g, device="cuda") + 0.5
    beta = torch.randn(c, generator=g, device="cuda") * 0.1
    gy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    for _ in range(20):
        pre = instance_norm_plain(x.float(), gamma, beta, act=None).abs()
        if float(pre.min()) > 1e-4:
            return x, gamma, beta, gy
        x = torch.where(pre < 1e-3, x.float() + 0.25, x.float()).to(dtype)
    raise AssertionError("could not move the input off the ReLU kink")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,want", NORM_CASES)
@pytest.mark.parametrize("act", ["relu", None])
@pytest.mark.parametrize("need_dx", [True, False])
def test_fused_instance_norm_backward_matches_autograd_of_plain(dtype, shape, want, act, need_dx):
    """f32 sums and f32 dx: 1e-4 * max|ref| + 1e-5 (other summation order);
    bf16 dx: one bf16 rounding, 2^-7 * (max|ref| + |ref|)."""
    _need_card()
    x, gamma, beta, gy = _norm_case(shape, dtype)
    if dtype == torch.bfloat16:
        p = plan_for(x, backward=True)
        assert (p.regime, p.cluster) == want
    x.requires_grad_(need_dx)
    gamma.requires_grad_()
    beta.requires_grad_()
    inputs = ((x,) if need_dx else ()) + (gamma, beta)
    before = (fused_instance_norm.backward_launches, instance_norm_backward_plain.cuda_calls)
    got = torch.autograd.grad(fused_instance_norm(x, gamma, beta, act=act), inputs, gy)
    torch.cuda.synchronize()
    assert fused_instance_norm.backward_launches == before[0] + 1
    assert instance_norm_backward_plain.cuda_calls == before[1]  # never the plain one on the card
    ref = torch.autograd.grad(instance_norm_plain(x, gamma, beta, act=act), inputs, gy)
    for u, v in zip(got, ref):
        assert u.dtype == v.dtype and u.shape == v.shape
        diff = (u.float() - v.float()).abs()
        vmax = float(v.float().abs().max())
        if u.dtype == torch.bfloat16:
            assert bool((diff <= 2.0 ** -7 * (vmax + v.float().abs())).all()), float(diff.max())
        else:
            assert float(diff.max()) <= 1e-4 * vmax + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,want", NORM_CASES)
def test_fused_instance_norm_is_bitwise_repeatable(shape, want):
    _need_card()
    x, gamma, beta, gy = _norm_case(shape, torch.bfloat16, seed=3)
    runs = []
    for _ in range(3):
        y, stats = instance_norm_forward(x, gamma, beta)
        runs.append((y, stats) + instance_norm_backward(gy, x, gamma, beta, stats, relu=True))
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(u, v) for u, v in zip(runs[0], other))


@pytest.mark.cuda
def test_fused_instance_norm_runs_on_the_current_stream():
    _need_card()
    x, gamma, beta, gy = _norm_case((2, 24, 72, 72, 32), torch.bfloat16, seed=5)
    want = instance_norm_plain(x, gamma, beta)
    xr = x.detach().requires_grad_()
    want_dx = torch.autograd.grad(instance_norm_plain(xr, gamma, beta), xr, gy)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = fused_instance_norm(xr, gamma, beta)
        dx = torch.autograd.grad(y, xr, gy)[0]
    side.synchronize()
    assert bool(((y.float() - want.float()).abs() <= 5e-2 + 2.0 ** -7 * want.float().abs()).all())
    lim = 2.0 ** -7 * (want_dx.float().abs().max() + want_dx.float().abs())
    assert bool(((dx.float() - want_dx.float()).abs() <= lim).all())


# the nine norm shapes of the training step at the recipe's batch 8, with the
# regime each takes (forward, backward); the first is 509 MB in bf16
TRAIN_CASES = [((8, 48, 144, 144, 32), "streaming", "streaming"), ((8, 24, 72, 72, 32), "streaming", "streaming"),
               ((8, 24, 72, 72, 64), "streaming", "streaming"), ((8, 12, 36, 36, 64), "resident", "resident"),
               ((8, 12, 36, 36, 128), "resident", "resident"), ((8, 6, 18, 18, 128), "resident", "resident"),
               ((8, 6, 18, 18, 256), "resident", "resident"), ((8, 3, 9, 9, 256), "resident", "resident"),
               ((8, 3, 9, 9, 512), "resident", "resident")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,fwd,bwd,dtype", [c + (torch.bfloat16,) for c in TRAIN_CASES]
                         + [TRAIN_CASES[0] + (torch.float32,), TRAIN_CASES[-1] + (torch.float32,)])
def test_fused_instance_norm_at_the_batch8_training_shapes(shape, fwd, bwd, dtype):
    """Forward and backward kernels against their plain versions on the same
    statistics, ReLU on as in the model, every shape in bf16 and the largest
    (1.02 GB) and the smallest also in f32; the tolerances of the other tests
    (f32 sums: 1e-4 * max|ref| + 1e-5)."""
    _need_card()
    x, gamma, beta, gy = _norm_case(shape, dtype, seed=7)
    assert plan_for(x).regime == fwd and plan_for(x, backward=True).regime == bwd
    _forward_and_backward_match_plain(x, gamma, beta, gy, dtype)


# the norm shapes of windowed Tent: the stock 4 windows of [32,96,96]
# (configs/tta/tent.yaml) down the flagship's levels
WINDOW_CASES = [(4, 32 >> lv, 96 >> lv, 96 >> lv, c)
                for lv, cs in enumerate(((32,), (32, 64), (64, 128), (128, 256), (256, 512))) for c in cs]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WINDOW_CASES)
def test_fused_instance_norm_at_the_window_shapes(shape):
    """Windowed Tent's shapes, bf16, forward and backward against the plain
    versions with the tolerances of the batch-8 test."""
    _need_card()
    x, gamma, beta, gy = _norm_case(shape, torch.bfloat16, seed=8)
    _forward_and_backward_match_plain(x, gamma, beta, gy, torch.bfloat16)


def _forward_and_backward_match_plain(x, gamma, beta, gy, dtype):
    y, stats = instance_norm_forward(x, gamma, beta, relu=True)
    want_y, mean, rstd = _plain_forward(x, gamma, beta, 1e-5, True)
    atol, rtol = TOLS[dtype]
    assert bool(((y.float() - want_y.float()).abs() <= atol + rtol * want_y.float().abs()).all())
    del want_y
    got = instance_norm_backward(gy, x, gamma, beta, stats, relu=True)
    ref = instance_norm_backward_plain(gy, x, gamma, beta, stats[0], stats[1], True)
    torch.cuda.synchronize()
    for name, u, v in zip(("dx", "dgamma", "dbeta"), got, ref):
        diff = (u.float() - v.float()).abs()
        vmax = float(v.float().abs().max())
        if name == "dx" and dtype == torch.bfloat16:
            assert bool((diff <= 2.0 ** -7 * (vmax + v.float().abs())).all()), name
        else:
            assert float(diff.max()) <= 1e-4 * vmax + 1e-5, name
    assert torch.allclose(stats[0], mean, atol=1e-5, rtol=1e-5)
    assert torch.allclose(stats[1], rstd, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_fused_instance_norm_backward_rejects_a_wrong_gradient():
    _need_card()
    x, gamma, beta, gy = _norm_case((1, 2, 4, 4, 16), torch.float32)
    stats = torch.zeros(2, 1, 16, device="cuda")
    with pytest.raises(ValueError, match="gradient"):
        instance_norm_backward(gy.bfloat16(), x, gamma, beta, stats, relu=True)
    with pytest.raises(ValueError, match="gradient"):
        instance_norm_backward(gy[:, :1], x, gamma, beta, stats, relu=True)
    with pytest.raises(ValueError, match="beta"):
        instance_norm_backward(gy, x, gamma, beta.double(), stats, relu=True)
    with pytest.raises(ValueError, match="stats"):
        instance_norm_backward(gy, x, gamma, beta, stats[0], relu=True)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 48, 144, 144), (4, 48, 144, 144), (8, 48, 144, 144), (3, 5, 7, 13),
                                   (2, 20, 31, 155), (1, 33, 260, 36), (2, 12, 36, 60), (1, 1, 1, 1)])
@pytest.mark.parametrize("spacing", [(3.0, 1.0, 1.0), (0.5, 2.0, 1.25)])
@pytest.mark.parametrize("sqrt", [False, True])
def test_squared_edt_volumes_is_bitwise_the_plain_version(shape, spacing, sqrt):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    pts = torch.rand(shape, generator=g, device="cuda") > 0.98
    if shape[0] > 1:
        pts[0] = False  # a volume without points stays +inf
    before = minplus.launches
    got = squared_edt_volumes(pts, spacing, sqrt=sqrt)
    torch.cuda.synchronize()
    assert minplus.launches == before + 1  # all volumes and all three axes in one launch
    assert got.dtype == torch.float32 and got.shape == pts.shape and got.is_contiguous()
    assert not torch.isnan(got).any()
    assert torch.equal(got, squared_edt_volumes_plain(pts, spacing, sqrt=sqrt))
    assert torch.equal(got, squared_edt_volumes(pts, spacing, sqrt=sqrt))  # run to run
    if shape[0] > 1:
        assert torch.isinf(got[0]).all()
    assert torch.equal(got, squared_edt_volumes(pts.to(torch.float32), spacing, sqrt=sqrt))
    odd = torch.zeros(pts.numel() + 1, dtype=torch.bool, device="cuda")[1:].view(shape)
    odd.copy_(pts)  # a mask that is not 16-byte aligned takes the scalar loads
    assert torch.equal(got, squared_edt_volumes(odd, spacing, sqrt=sqrt))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [0, 1])
def test_squared_edt_volumes_of_constant_masks(fill):
    _need_card()
    pts = torch.full((2, 6, 10, 12), bool(fill), device="cuda")
    got = squared_edt_volumes(pts, (1.0, 2.0, 3.0))
    assert bool((got == 0).all()) if fill else bool(torch.isinf(got).all())


@pytest.mark.cuda
def test_squared_edt_volumes_runs_on_the_current_stream():
    _need_card()
    pts = torch.rand(2, 16, 40, 24, device="cuda") > 0.97
    want = squared_edt_volumes_plain(pts, (3.0, 1.0, 1.0))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = squared_edt_volumes(pts, (3.0, 1.0, 1.0))
        second = squared_edt_volumes(pts, (3.0, 1.0, 1.0))  # shares the stream's tile counters
    side.synchronize()
    assert torch.equal(first, want) and torch.equal(second, want)


@pytest.mark.cuda
def test_squared_edt_volumes_rejects_what_the_kernel_does_not_take():
    _need_card()
    pts = torch.zeros(2, 4, 6, 8, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="V, D, H, W"):
        squared_edt_volumes(pts[0], (1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="contiguous"):
        squared_edt_volumes(pts.transpose(1, 2), (1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="spacing"):
        squared_edt_volumes(pts, (1.0, -1.0, 1.0))
    with pytest.raises(ValueError, match="shared memory"):
        squared_edt_volumes(torch.zeros(1, 2, 2, 4000, dtype=torch.bool, device="cuda"), (1.0, 1.0, 1.0))


@pytest.mark.cuda
def test_seg_trainer_step_runs_the_norm_kernels():
    """One training step of a small bf16 UNet3D on the card: every norm layer
    launches its forward and its backward kernel once, the plain backward
    never runs, the loss is finite and every parameter moves."""
    _need_card()
    import numpy as np

    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.optim import build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
    from multimodal_tta_tpu_torch.models.layers import InstanceNorm
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D

    cfg = ConfigNode({"task": {"seed": 0}, "training": {
        "optimizer": "adam", "optimizers": {"adam": {"lr": 1e-3, "weight_decay": 5e-4}},
        "criterion": {"sigmoid": True, "lambda_dice": 5.0, "ce_weight": [50.0]}}})
    model = UNet3D(channels=(16, 32, 64), strides=(2, 2), dtype=torch.bfloat16, device="cuda", seed=0)
    n_norm = sum(isinstance(m, InstanceNorm) for m in model.modules())
    trainer = SegTrainer(cfg, device_transform={"normalize": True})
    trainer.setup(TrainState(model=model, optimizer=build_optimizer(cfg.training, model)[0]))
    rng = np.random.RandomState(0)
    batch = {"image": (rng.randn(2, 16, 32, 32, 2) * 100).astype(np.float32),
             "label": (rng.rand(2, 16, 32, 32, 1) > 0.9).astype(np.float32)}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    counts = (fused_instance_norm.launches, fused_instance_norm.backward_launches,
              instance_norm_backward_plain.cuda_calls)
    trainer.run_step(batch)
    loss = trainer.flush_step_metrics()["loss"]
    torch.cuda.synchronize()
    assert (fused_instance_norm.launches - counts[0], fused_instance_norm.backward_launches - counts[1],
            instance_norm_backward_plain.cuda_calls - counts[2]) == (n_norm, n_norm, 0)
    assert np.isfinite(loss)
    assert all(not torch.equal(p, before[n]) for n, p in model.named_parameters())


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(tmp_path):
    """A checkpoint of a model and its Adam state on the card restores
    bitwise into another, each tensor where the live one lives (Adam's step
    counts on the host), and the restored optimizer steps."""
    _need_card()
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
    from multimodal_tta_tpu_torch.core.optim import build_optimizer
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D

    training = ConfigNode({"optimizer": "adam", "optimizers": {"adam": {"lr": 1e-3, "weight_decay": 5e-4}}})

    def state(seed):
        model = UNet3D(channels=(8, 16, 32), strides=(2, 2), device="cuda", seed=seed)
        return TrainState(model=model, optimizer=build_optimizer(training, model)[0])

    src = state(0)
    for _ in range(2):
        for p in src.model.parameters():
            p.grad = torch.randn_like(p)
        src.apply_gradients()
    src.ema_params = {n: p.detach() * 0.5 for n, p in src.model.named_parameters()}
    save_checkpoint(str(tmp_path / "c"), src, {"epoch": 3})
    got, meta = load_checkpoint(str(tmp_path / "c"), state(1))
    assert meta == {"epoch": 3, "_format": "msgpack"} and got.step == 2
    for (n, p), q in zip(got.model.named_parameters(), src.model.parameters()):
        assert p.is_cuda and torch.equal(p, q) and torch.equal(got.ema_params[n], src.ema_params[n])
    live = [v for st in src.optimizer.state.values() for v in st.values()]
    back = [v for st in got.optimizer.state.values() for v in st.values()]
    assert all(u.device == v.device and torch.equal(u, v) for u, v in zip(live, back))
    for p in got.model.parameters():
        p.grad = torch.ones_like(p)
    got.apply_gradients()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sar_step_kernel_matches_plain_norm_in_f32():
    """One f32 SAR step (two forwards and two backwards: the SAM ascent and
    descent) through the norm kernels against the same step through the
    plain norm: entropy within 1e-4 relative, norm-param deltas within 1e-3
    relative L2 (the limits of chip_smoke.py's training parity), with
    TF32 off as in chip_smoke.py (with the default TF32 convolutions the
    check failed on the card)."""
    _need_card()
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _sar_step_kernel_vs_plain()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _sar_step_kernel_vs_plain():
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.models.layers import InstanceNorm, set_plain_norm
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D
    from multimodal_tta_tpu_torch.tta.sar import SarAdapter

    x = torch.randn((2, 16, 32, 32, 2), generator=torch.Generator("cuda").manual_seed(3), device="cuda")
    cfg = ConfigNode({"task": {"seed": 0}, "tta": {"method": "sar", "steps": 1, "lr": 1e-2,
                                                    "entropy_focus": "uncertain", "margin_ratio": 1.0,
                                                    "reset_floor_ratio": 0.0}})
    out = {}
    for plain in (False, True):
        model = UNet3D(channels=(16, 32, 64), strides=(2, 2), device="cuda", seed=4)
        n_norm = sum(isinstance(m, InstanceNorm) for m in model.modules())
        set_plain_norm(model, plain)
        ad = SarAdapter(cfg.tta, config=cfg, device="cuda")
        fn = ad.make_adapt_fn(model)
        src = [p.detach().clone() for p in ad._trainable]
        at = (fused_instance_norm.launches, fused_instance_norm.backward_launches)
        fn(model, x, 2)
        torch.cuda.synchronize()
        ran = (fused_instance_norm.launches - at[0], fused_instance_norm.backward_launches - at[1])
        out[plain] = (ad.last_entropy, torch.cat([(p.detach() - q).flatten() for p, q in zip(ad._trainable, src)]),
                      ran)
    (e_k, d_k, ran_k), (e_p, d_p, ran_p) = out[False], out[True]
    assert ran_k == (2 * n_norm, 2 * n_norm) and ran_p == (0, 0), (ran_k, ran_p, n_norm)
    assert abs(e_k - e_p) <= 1e-4 * abs(e_p), (e_k, e_p)
    rel = float((d_k - d_p).norm() / d_p.norm())
    assert float(d_p.norm()) > 0 and rel <= 1e-3, (float(d_p.norm()), rel)


# the norm shapes of the serving artifact's step: one flagship forward at batch 2
SERVING_NORM_SHAPES = [(2, 48, 144, 144, 32), (2, 24, 72, 72, 64), (2, 12, 36, 36, 128), (2, 6, 18, 18, 256),
                       (2, 3, 9, 9, 512), (2, 6, 18, 18, 128), (2, 12, 36, 36, 64), (2, 24, 72, 72, 32),
                       (2, 48, 144, 144, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(set(SERVING_NORM_SHAPES)))
def test_norm_operators_at_the_serving_shapes(shape):
    """``torch.ops.mtta.fused_instance_norm_forward`` / ``_backward`` called
    as a replayed program calls them, at the serving step's shapes (bf16):
    each launches its kernel once and agrees with the plain versions."""
    _need_card()
    x, gamma, beta, gy = _norm_case(shape, torch.bfloat16)
    at = (fused_instance_norm.launches, fused_instance_norm.backward_launches)
    y, stats = torch.ops.mtta.fused_instance_norm_forward(x, gamma, beta, 1e-5, True)
    dx, dgamma, dbeta = torch.ops.mtta.fused_instance_norm_backward(gy, x, gamma, beta, stats, True, True)
    _, _, dbeta_only = torch.ops.mtta.fused_instance_norm_backward(gy, x, gamma, beta, stats, True, False)
    torch.cuda.synchronize()
    assert (fused_instance_norm.launches - at[0], fused_instance_norm.backward_launches - at[1]) == (1, 2)
    want_y = _plain_forward(x, gamma, beta, 1e-5, True)[0]
    atol, rtol = TOLS[torch.bfloat16]
    assert bool(((y.float() - want_y.float()).abs() <= atol + rtol * want_y.float().abs()).all())
    ref = instance_norm_backward_plain(gy, x, gamma, beta, stats[0], stats[1], True)
    assert torch.equal(dbeta, dbeta_only)
    # the tolerances of the other backward tests: bf16 dx one rounding, f32 sums
    for name, u, v in zip(("dx", "dgamma", "dbeta"), (dx, dgamma, dbeta), ref):
        assert u.dtype == v.dtype and u.shape == v.shape, name
        diff, vmax = (u.float() - v.float()).abs(), float(v.float().abs().max())
        if name == "dx":
            assert bool((diff <= 2.0 ** -7 * (vmax + v.float().abs())).all()), name
        else:
            assert float(diff.max()) <= 1e-4 * vmax + 1e-5, name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["inline", "post"])
def test_serving_artifact_on_the_card(tmp_path, mode):
    """A small bf16 UNet3D's Tent artifact exported, saved and loaded on the
    card: each call launches the norm kernels as the live step does (no
    plain backward) and gives the live step's entropies and predictions."""
    _need_card()
    from multimodal_tta_tpu_torch.conf import ConfigNode
    from multimodal_tta_tpu_torch.models.layers import InstanceNorm
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D
    from multimodal_tta_tpu_torch.serving import export_adapt_serving, load_artifact, save_artifact
    from multimodal_tta_tpu_torch.tta.tent import TentAdapter

    cfg = ConfigNode({"task": {"seed": 0}, "tta": {"method": "tent", "steps": 1, "lr": 1e-2,
                                                    "episodic": mode == "post", "entropy_focus": "uncertain"}})
    kw = dict(channels=(16, 32, 64), strides=(2, 2), dtype=torch.bfloat16, device="cuda", seed=5)
    shape = (2, 16, 32, 32, 2)
    ad = TentAdapter(cfg.tta, config=cfg, device="cuda")
    program, meta, state0 = export_adapt_serving(ad, UNet3D(**kw), shape, threshold=0.3, predict_mode=mode)
    save_artifact(str(tmp_path / "a.mttap"), program, meta, state0)
    art = load_artifact(str(tmp_path / "a.mttap"))
    live = TentAdapter(cfg.tta, config=cfg, device="cuda")
    model = UNet3D(**kw)
    n = sum(isinstance(m, InstanceNorm) for m in model.modules())
    fn = live.make_adapt_predict_fn(model, 0.3, mode)
    state = art.initial_state()
    g = torch.Generator("cuda").manual_seed(7)
    for _ in range(2):
        x = torch.randn(shape, generator=g, device="cuda") * 100
        at = (fused_instance_norm.launches, fused_instance_norm.backward_launches,
              instance_norm_backward_plain.cuda_calls)
        out = art.call(*(art.initial_state() if mode == "post" else state), x, 2, float("nan"))
        torch.cuda.synchronize()
        ran = (fused_instance_norm.launches - at[0], fused_instance_norm.backward_launches - at[1],
               instance_norm_backward_plain.cuda_calls - at[2])
        assert ran == ((2 * n, n, 0) if mode == "post" else (n, n, 0)), ran
        state = list(out[:art.n_state])
        _, pred = fn(model, x, 2)
        assert torch.equal(out[art.n_state], live._last_ents)
        assert torch.equal(out[art.n_state + 1], pred)
