"""Parity of the port's transformer segmenters with the flax ones
(multimodal_tta_tpu_torch/models/: ``vit.py``'s ``SelfAttention`` and
``EncoderBlock``, ``unetr.py``, ``swin_unetr.py``, the ``LayerNorm`` of
``layers.py``), the same flax params carried across by
``models/convert.py:from_flax``, inputs made with numpy from a seed.

Fixtures: UNETR with patch 4, hidden 32, mlp 64, 4 heads, 4 layers,
feature 4 on [1,16,16,16,2] and on the anisotropic [1,8,16,12,2];
SwinUNETR with feature 4, depths (2,2), heads (2,4), window 2, patch 2 on
[1,12,16,20,2], where stage 1 ([3,4,5]) pads to the window grid and shifts
and the decoder crops ``dec2_up``'s [4,4,6] back to [3,4,5].

Tolerances:
  - the windowing helpers: equal to the reference's exactly;
  - ``LayerNorm``, ``SelfAttention``, ``EncoderBlock`` (its MLP's exact
    GELU), ``SwinBlock`` and ``PatchMerging`` alone: max abs 1e-5 in f32;
  - the logits: max abs 1e-4 in f32, relative L2 5e-2 in bf16 (the bounds
    of tests/test_torch_seg_models.py);
  - gradients against ``jax.grad`` of the reference, remat on and off:
    1e-3 relative L2 over all parameters;
  - one Tent step through the adapters: the norm params' deltas within 1e-3
    relative L2, predictions equal on 99.9% of voxels, entropies 1e-5
    relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import chip_smoke
from multimodal_tta_tpu.conf import compose as jax_compose
from multimodal_tta_tpu.models import swin_unetr as jsw
from multimodal_tta_tpu.models import vit as jvit
from multimodal_tta_tpu.models.swin_unetr import SwinUNETR as JaxSwin
from multimodal_tta_tpu.models.unetr import UNETR as JaxUNETR
from multimodal_tta_tpu.tta.tent import TentAdapter as JaxTent
from multimodal_tta_tpu.tta.tent import norm_param_mask as jax_norm_param_mask
from multimodal_tta_tpu_torch.cli import CONFIG_DIR
from multimodal_tta_tpu_torch.conf import ConfigNode, compose
from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
from multimodal_tta_tpu_torch.data.synthetic import make_hecktor_fixture
from multimodal_tta_tpu_torch.models import SwinUNETR, UNETR
from multimodal_tta_tpu_torch.models import layers as tl
from multimodal_tta_tpu_torch.models import swin_unetr as tsw
from multimodal_tta_tpu_torch.models import vit as tvit
from multimodal_tta_tpu_torch.models.convert import flax_path, from_flax
from multimodal_tta_tpu_torch.registry import get_model
from multimodal_tta_tpu_torch.tta.tent import TentAdapter, norm_param_mask
from tests._torch_port import (
    NormCalls,
    assert_adapted_close,
    assert_preds_close,
    flat_flax,
    np_params,
    random_flax_params,
    randomize,
    run_jax_adapter,
    run_torch_adapter,
    tta_config,
)

torch.set_num_threads(2)

UNETR_KW = dict(in_channels=2, num_classes=1, patch_size=4, hidden_size=32, mlp_dim=64, num_heads=4, num_layers=4,
                feature_size=4)
SWIN_KW = dict(in_channels=2, num_classes=1, feature_size=4, depths=(2, 2), num_heads=(2, 4), window_size=2,
               patch_size=2)
# (flax class, port class, kwargs, input shape)
CASES = {"unetr": (JaxUNETR, UNETR, UNETR_KW, (1, 16, 16, 16, 2)),
         "unetr_aniso": (JaxUNETR, UNETR, UNETR_KW, (1, 8, 16, 12, 2)),
         "swin_unetr": (JaxSwin, SwinUNETR, SWIN_KW, (1, 12, 16, 20, 2))}
# norm calls of one fixture forward: UNETR's skip branch 1, stem 2, decoder
# 4; SwinUNETR's bottleneck 2 and two ConvBlock pairs at each of 3 levels
PER_FORWARD = {"unetr": 7, "unetr_aniso": 7, "swin_unetr": 14}


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    return {name: random_flax_params(j(**kw), shape, seed=i + 1)
            for i, (name, (j, _, kw, shape)) in enumerate(CASES.items())}


@pytest.fixture(scope="module")
def jax_fns():
    """Each flax model's jitted apply (f32, bf16) and gradient (remat off,
    on), built once for the module."""
    out = {}
    for name, (j, _, kw, _) in CASES.items():
        f32, b16 = j(**kw), j(**kw, dtype=jnp.bfloat16)
        out[name] = {"f32": jax.jit(lambda p, a, m=f32: m.apply({"params": p}, a)),
                     "bf16": jax.jit(lambda p, a, m=b16: m.apply({"params": p}, a))}
        for remat in (False, True):
            jm = j(**kw, remat=remat)
            out[name][("grad", remat)] = jax.jit(jax.grad(
                lambda p, a, w, m=jm: jnp.sum(m.apply({"params": p}, a, train=True) * w)))
    return out


def _port(name, p, **kw):
    _, t, small, shape = CASES[name]
    m = t(**{**small, **kw}, image_size=shape[1:4], device="cpu")
    m.load_state_dict(from_flax(p), strict=True)
    return m


# ---- the windowing helpers ------------------------------------------------

@pytest.mark.parametrize("w", [(2, 2, 2), (2, 3, 4), (3, 4, 4), (4, 4, 4), (1, 2, 3)])
def test_rel_pos_index_equals_the_reference(w):
    np.testing.assert_array_equal(tsw._rel_pos_index(w), jsw._rel_pos_index(w))
    assert tsw._triple(w) == jsw._triple(w) and tsw._triple(3) == jsw._triple(3) == (3, 3, 3)


@pytest.mark.parametrize("dims,w,s", [((4, 4, 4), (2, 2, 2), (0, 0, 0)), ((4, 1, 1), (2, 1, 1), (1, 0, 0)),
                                      ((8, 20, 20), (4, 4, 4), (2, 2, 2)), ((3, 12, 12), (3, 4, 4), (0, 2, 2)),
                                      ((4, 4, 6), (2, 2, 2), (1, 1, 1))])
def test_shift_mask_equals_the_reference(dims, w, s):
    got, want = tsw._shift_mask(dims, w, s), jsw._shift_mask(dims, w, s)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for d, ws, sh in zip(dims, w, s):
        assert tsw._axis_slices(d, ws, sh) == jsw._axis_slices(d, ws, sh)


@pytest.mark.parametrize("shape,w", [((2, 4, 6, 8, 3), (2, 3, 4)), ((1, 8, 20, 20, 5), (4, 4, 4)),
                                     ((3, 3, 12, 12, 2), (3, 4, 4))])
def test_partition_round_trip_equals_the_reference(shape, w):
    x = _x(shape, seed=1)
    got = tsw._partition(torch.from_numpy(x), w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsw._partition(jnp.asarray(x), w)))
    back = tsw._unpartition(got, w, shape[1:4], shape[0])
    np.testing.assert_array_equal(back.numpy(), x)


# ---- the layers alone, f32 --------------------------------------------------

def _flax_apply(module, x, seed, **kw):
    p = randomize(np_params(module, x, **kw), seed)
    return p, np.asarray(module.apply({"params": p}, jnp.asarray(x), **kw))


@pytest.mark.parametrize("shape,loc", [((2, 7, 24), 0.0), ((3, 5, 48), 0.5), ((3, 5, 48), 40.0)])
def test_layer_norm(shape, loc):
    """flax's LayerNorm (eps 1e-6, f32 statistics, output in the compute
    dtype). flax takes the variance as E[x^2] - E[x]^2 in f32, the port
    (``F.layer_norm``) in two passes: at a mean of 40 over a spread of 2 the
    reference's variance loses about 1e-4 of itself (measured: max abs
    9.7e-5 between the two outputs), so there the port is held within 1e-5
    of an f64 LayerNorm and the reference's own gap to it is stated."""
    x = _x(shape, seed=2) * 2 + loc
    p, want = _flax_apply(fnn.LayerNorm(), x, 3)
    m = tl.LayerNorm(shape[-1])
    assert m.epsilon == 1e-6 and all(norm_param_mask(m).values()) and len(norm_param_mask(m)) == 2
    m.load_state_dict(from_flax(p), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
        assert tl.LayerNorm(shape[-1], dtype=torch.bfloat16)(torch.from_numpy(x)).dtype == torch.bfloat16
    x64 = x.astype(np.float64)
    exact = ((x64 - x64.mean(-1, keepdims=True)) / np.sqrt(x64.var(-1, keepdims=True) + 1e-6)
             * p["scale"].astype(np.float64) + p["bias"].astype(np.float64))
    np.testing.assert_allclose(got, exact, atol=1e-5)
    if loc < 10:
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert np.abs(want - exact).max() < 2e-4  # the reference's fast variance


def test_self_attention_and_encoder_block():
    x = _x((2, 9, 32), seed=5)
    p, want = _flax_apply(jvit.SelfAttention(hidden=32, heads=4), x, 6)
    assert p["query"]["kernel"].shape == (32, 4, 8) and p["out"]["kernel"].shape == (4, 8, 32)
    m = tvit.SelfAttention(32, 4)
    m.load_state_dict(from_flax(p), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), want, atol=1e-5)
    p, want = _flax_apply(jvit.EncoderBlock(hidden=32, heads=4, mlp_dim=64), x, 7)
    m = tvit.EncoderBlock(32, 4, 64)
    m.load_state_dict(from_flax(p), strict=True)
    assert {flax_path(n) for n in m.state_dict()} == set(flat_flax(p))
    with torch.no_grad():
        np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("dims,shift", [((6, 8, 10), True), ((3, 4, 5), True), ((3, 4, 5), False), ((2, 4, 4), True)])
def test_swin_block(dims, shift):
    """Padded, shifted and plain windows; at (2,4,4) the D axis holds one
    window, so only H and W shift."""
    x = _x((2,) + dims + (8,), seed=8)
    p, want = _flax_apply(jsw.SwinBlock(dim=8, heads=2, window=(2, 2, 2), shift=shift), x, 9)
    m = tsw.SwinBlock(8, 2, (2, 2, 2), shift, dims)
    m.load_state_dict(from_flax(p), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), want, atol=1e-5)
    win, sh, pads = tsw.stage_windows(dims, (2, 2, 2), shift)
    assert any(pads) == any(d % 2 for d in dims) and (any(sh) == shift)


@pytest.mark.parametrize("dims", [(4, 6, 8), (3, 5, 4)])
def test_patch_merging(dims):
    """The 8 neighbours in the reference's (dz, dy, dx, c) order; odd sizes
    zero-padded."""
    x = _x((2,) + dims + (6,), seed=10)
    p, want = _flax_apply(jsw.PatchMerging(dim=6), x, 11)
    m = tsw.PatchMerging(6)
    m.load_state_dict(from_flax(p), strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2,) + tuple(-(-d // 2) for d in dims) + (12,)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---- the models ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_logits_f32(params, jax_fns, name):
    shape = CASES[name][3]
    x = _x(shape, seed=12)
    want = np.asarray(jax_fns[name]["f32"](params[name], jnp.asarray(x)))
    with torch.no_grad():
        got = _port(name, params[name])(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == shape[:4] + (1,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_logits_bf16(params, jax_fns, name):
    x = _x(CASES[name][3], seed=13)
    want = np.asarray(jax_fns[name]["bf16"](params[name], jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = _port(name, params[name], dtype=torch.bfloat16)(torch.from_numpy(x)).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 5e-2, rel


@pytest.mark.parametrize("name,remat", [("unetr", False), ("unetr", True), ("swin_unetr", False),
                                        ("swin_unetr", True)])
def test_gradient_matches_jax_grad(params, jax_fns, name, remat):
    """f32 gradients of a weighted sum of the logits against ``jax.grad`` of
    the reference with the same remat; a rematerialized norm runs its
    forward again in the backward, as ``chip_smoke.remat_norms`` derives."""
    shape = CASES[name][3]
    x, w = _x(shape, seed=14), _x(shape[:4] + (1,), seed=15)
    m = _port(name, params[name], remat=remat)
    calls = NormCalls()
    try:
        (m(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
        assert calls.read() == {"forward": PER_FORWARD[name] + chip_smoke.remat_norms(m),
                                "backward": PER_FORWARD[name]}
    finally:
        calls.remove()
    want = from_flax(jax.tree_util.tree_map(np.asarray, jax_fns[name][("grad", remat)](
        params[name], jnp.asarray(x), jnp.asarray(w))))
    grads = dict(m.named_parameters())
    assert set(want) == set(grads)
    ref = torch.cat([g.flatten() for g in want.values()])
    got = torch.cat([grads[n].grad.flatten() for n in want])
    assert float((got - ref).norm() / ref.norm()) <= 1e-3


@pytest.mark.parametrize("name,remat,recomputed", [("unetr", True, 6), ("unetr", 1, 4), ("unetr", 3, 6),
                                                   ("unetr", False, 0), ("swin_unetr", True, 14),
                                                   ("swin_unetr", 1, 4), ("swin_unetr", 3, 12),
                                                   ("swin_unetr", 4, 14)])
def test_remat_norms_derivation(params, name, remat, recomputed):
    """The launch derivation of the chip smoke against the norm calls a
    backward makes: UNETR's skip branches are never rematerialized, and
    SwinUNETR's bottleneck only from level stages + 1 up."""
    m = _port(name, params[name], remat=remat)
    assert chip_smoke.remat_norms(m) == recomputed
    calls = NormCalls()
    try:
        m(torch.from_numpy(_x(CASES[name][3], seed=16))).sum().backward()
    finally:
        calls.remove()
    assert calls.read() == {"forward": PER_FORWARD[name] + recomputed, "backward": PER_FORWARD[name]}


@pytest.mark.parametrize("name", ["unetr", "swin_unetr"])
def test_tent_step_matches_the_reference(params, name):
    """Episodic Tent with post-update predictions on two batches of 2
    through the JAX adapter and the port's: the LayerNorm and InstanceNorm
    affines move alike."""
    j, _, kw, shape = CASES[name]
    cfg = tta_config()
    rng = np.random.RandomState(17)
    batches = [(rng.randn(2, *shape[1:]) * 100).astype(np.float32) for _ in range(2)]
    j_adapted, j_ents, j_preds, _ = run_jax_adapter(JaxTent, params[name], cfg, batches, 2, "post", module=j(**kw))
    model = _port(name, params[name])
    source = {k: v.detach().clone() for k, v in model.state_dict().items()}
    t_adapted, t_ents, t_preds, _ = run_torch_adapter(TentAdapter, params[name], cfg, batches, 2, "post",
                                                      model=model)
    for a, b in zip(t_ents, j_ents):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    names = [n for n, v in norm_param_mask(model).items() if v]
    assert any("LayerNorm" in n or "ln_" in n for n in names) and any(".n.norm." in n for n in names)
    assert_adapted_close(t_adapted, j_adapted, source, names, rel=1e-3)
    assert_preds_close(t_preds, j_preds)


@pytest.mark.parametrize("name", sorted(CASES))
def test_param_tree_and_norm_mask_match_flax(params, name):
    """Names and counts at fixture size, the shapes in the layouts of
    convert.py, and the structural norm mask against the JAX mask."""
    m = _port(name, params[name])
    flat = flat_flax(params[name])
    assert {flax_path(n) for n, _ in m.named_parameters()} == set(flat)
    jmask = flat_flax(jax_norm_param_mask(params[name]))
    mask = norm_param_mask(m)
    assert {flax_path(n) for n, v in mask.items() if v} == {k for k, v in jmask.items() if v}
    assert sum(mask.values()) == sum(bool(v) for v in jmask.values()) > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_weight_bridge_round_trip(params, name):
    """from_flax, then back to flax through flax_path, name by name, bitwise:
    the attention kernels reshaped back to [H, heads, hd] / [heads, hd, H],
    the q/k/v biases to [heads, hd]."""
    flat = flat_flax(params[name])
    back = {}
    for n, p in _port(name, params[name]).state_dict().items():
        a, path = p.numpy(), flax_path(n)
        want = np.asarray(flat[path])
        if path.endswith("kernel") and want.ndim == 3:
            a = a.T.reshape(want.shape)
        elif path.endswith("kernel") and a.ndim == 2:
            a = a.T
        elif path.endswith("/up/kernel"):
            a = a.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]
        elif path.endswith("kernel"):
            a = a.transpose(2, 3, 4, 1, 0)
        back[path] = a.reshape(want.shape)
    assert set(back) == set(flat)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(back[path], np.asarray(leaf), err_msg=path)


STOCK = {"unetr": (267, 82, 96_351_873), "swin_unetr": (238, 94, 69_596_023)}


@pytest.mark.parametrize("name", sorted(STOCK))
def test_stock_configs_build_the_paper_models(name):
    """configs/model/<name>.yaml composed into the HECKTOR21 recipe and built
    as ExperimentManager.setup_model builds it (the recipe's ``channels``,
    ``strides``, ``drop_rate`` ... ignored, ``image_size`` from
    ``training.data.transforms``), on the CPU, not initialised and not run:
    the reference's param tree (``jax.eval_shape`` of the JAX model from the
    JAX compose) and Tent's counts. The manager itself builds the fixture
    models of test_chip_smoke_transformer_phase_runs_on_the_cpu."""
    over = ["task=hecktor21", "dataset=hecktor21", f"model={name}", "training.remat=true"]
    cfg = compose(CONFIG_DIR, "config", over)
    model = get_model(name).from_config(cfg.model, dtype=torch.bfloat16, remat=cfg.training.remat, device="cpu",
                                        image_size=cfg.training.data.transforms.image_size, seed=None)
    assert model.remat is True and model.image_size == (48, 144, 144) and model.dtype == torch.bfloat16
    n_tensors, n_norm, n_weights = STOCK[name]
    assert len(list(model.parameters())) == n_tensors and sum(norm_param_mask(model).values()) == n_norm
    assert sum(p.numel() for p in model.parameters()) == n_weights
    jcfg = jax_compose(CONFIG_DIR, "config", over)
    jm = {"unetr": JaxUNETR, "swin_unetr": JaxSwin}[name].from_config(jcfg.model)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 48, 144, 144, 2))))["params"]
    want = {k: int(np.prod(v.shape)) for k, v in flat_flax(shapes).items()}
    assert {flax_path(n): p.numel() for n, p in model.named_parameters()} == want
    assert sum(bool(v) for v in flat_flax(jax_norm_param_mask(shapes)).values()) == n_norm


def test_registry_defaults_and_what_is_not_ported(monkeypatch):
    cfg = ConfigNode({**UNETR_KW, "channels": [4, 8], "strides": [2], "drop_rate": 0.2, "moe_aux_weight": 0.01,
                      "moe_every": 2})
    assert get_model("unetr") is UNETR and get_model("swin_unetr") is SwinUNETR
    m = get_model("unetr").from_config(cfg, image_size=(16, 16, 16), device="cpu", seed=1)
    again = get_model("unetr").from_config(cfg, image_size=(16, 16, 16), device="cpu", seed=1)
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), again.parameters())) and not m.training
    assert float(m.pos_embed.detach().std()) == pytest.approx(0.02, rel=0.2)
    sw = get_model("swin_unetr").from_config(ConfigNode(SWIN_KW), image_size=(12, 16, 20), device="cpu", seed=1)
    tables = [b.rel_pos_bias.detach() for b in sw.modules() if isinstance(b, tsw.WindowAttention)]
    assert len(tables) == 4 and all(float(t.abs().max()) > 0 for t in tables)
    with pytest.raises(ValueError, match="image_size"):
        get_model("unetr").from_config(cfg, device="cpu")
    no_size = compose(CONFIG_DIR, "config", ["task=hecktor21", "dataset=hecktor21", "model=swin_unetr",
                                             "training.data.transforms.image_size=null"])
    with pytest.raises(ValueError, match="image_size"):  # the reference's ExperimentManager raises alike
        ExperimentManager(no_size, device="cpu").setup_model()
    with pytest.raises(ValueError, match="pos_embed has 64 rows"):
        m(torch.zeros(1, 16, 16, 8, 2))
    with torch.no_grad():  # another grid with the same windows runs, as in flax
        assert sw(torch.zeros(1, 12, 16, 16, 2)).shape == (1, 12, 16, 16, 1)
    with pytest.raises(ValueError, match="takes the window"):
        sw(torch.zeros(1, 2, 16, 16, 2))
    # tp_axis builds the blocks that a model axis cuts (tests/test_torch_tensor_parallel.py)
    assert UNETR(**UNETR_KW, tp_axis="model", image_size=(16, 16, 16), device="cpu").block0.tp_axis == "model"
    # the sequence axis builds and, without a space axis, computes the same
    # (over ranks: tests/test_torch_sequence_axis.py)
    seq = UNETR(**UNETR_KW, seq_shard_axis="space", image_size=(16, 16, 16), device="cpu", seed=1)
    with torch.no_grad():
        x = torch.from_numpy(np.random.RandomState(9).randn(1, 16, 16, 16, 2).astype(np.float32))
        assert torch.equal(seq(x), m(x))
    # moe_experts and num_experts raised before the training-options slice;
    # blocks 1 and 3 route (every moe_every=2-th), tests/test_torch_moe.py
    # holds them to flax
    moe = UNETR(**UNETR_KW, moe_experts=4, image_size=(16, 16, 16), device="cpu")
    assert [i for i in range(4) if getattr(moe, f"block{i}").num_experts] == [1, 3]
    assert moe.block1.moe.num_experts == 4 and not hasattr(moe.block1, "Dense_0")
    assert tvit.EncoderBlock(32, 4, 64, num_experts=2).moe.wi.shape == (2, 32, 64)
    assert tvit.SelfAttention(32, 4, tp_axis="model").tp is None  # cut only over a model axis
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("swin_unetr").from_config(ConfigNode(SWIN_KW), image_size=(12, 16, 20))


# ---- chip_smoke.py's phase 17 at fixture size -------------------------------

FIXTURE_MODELS = {"unetr": ["model.patch_size=4", "model.hidden_size=32", "model.mlp_dim=64", "model.num_heads=4",
                            "model.num_layers=4", "model.feature_size=4"],
                  "swin_unetr": ["model.feature_size=4", "model.depths=[2,2]", "model.num_heads=[2,4]",
                                 "model.window_size=2"]}


@pytest.mark.parametrize("name,shape", [("unetr", (16, 16, 16)), ("swin_unetr", (12, 16, 20))])
def test_chip_smoke_transformer_phase_runs_on_the_cpu(tmp_path, name, shape):
    """chip_smoke.py's phase 17 at fixture size on the CPU (f32, batch 2):
    training with remat, TTAEngine.evaluate, the serving step, the f32 Tent
    step and the three CLIs, with every check they make; the norm calls
    counted by a module hook (on the card, each is a kernel launch) against
    what remat and the step structure derive."""
    common = FIXTURE_MODELS[name] + ["training.compute_dtype=float32", "training.batch_size=2",
                                     "training.num_workers=0"]
    per_fwd, recompute = PER_FORWARD[name], {"unetr": 6, "swin_unetr": 14}[name]
    manifest = make_hecktor_fixture(str(tmp_path / "data"), shape=(16, 16, 16),
                                    centers={"CHUS": 2, "CHUM": 4, "CHGJ": 4}, seed=7)
    calls = NormCalls()
    try:
        out = chip_smoke.transformer_train_and_serve("cpu", name, str(tmp_path / "serve"), shape=shape, small=shape,
                                                     extra=common, reset_counts=calls.reset,
                                                     read_counts=calls.read, per_forward=per_fwd)
        cli = chip_smoke.transformer_cli("cpu", name, manifest, str(tmp_path / "cli"), extra=common + [
            "dataset.expected_shape=[16,16,16]", "training.data.transforms.image_size=[16,16,16]"],
            reset_counts=calls.reset, read_counts=calls.read, per_forward=per_fwd)
    finally:
        calls.remove()
    t = out["train"]
    assert t["steps"] == 16 and t["val_batches"] == 2 and t["recompute"] == recompute and not t["unmoved"]
    assert t["launches"] == {"forward": 16 * (per_fwd + recompute) + 2 * per_fwd, "backward": 16 * per_fwd}
    assert [e["shape"][1:] for e in t["edt"]] == [list(shape)] * 2
    assert set(out["tta"]) == {tag for tag, _ in chip_smoke.TRANSFORMER_TTA_RUNS}
    # each evaluated batch: the Tent step (its forward, the recompute, the
    # backward), then the evaluation forward
    assert out["tta"]["tent_episodic_post"]["launches"] == {"forward": 2 * (2 * per_fwd + recompute),
                                                            "backward": 2 * per_fwd}
    for proto, post in (("online", 0), ("strict", 1)):
        r = out["serving"][proto]
        assert r["launches"] == {"forward": 4 * ((1 + post) * per_fwd + recompute), "backward": 4 * per_fwd}
        assert r["grad_reached"] == r["norm_tensors"] > 0
    assert out["f32_step"]["predictions_agree"] >= 0.999
    assert cli["train"]["model"] == get_model(name).__name__
    assert cli["train"]["launches"] == {"forward": per_fwd * 3, "backward": per_fwd * 2}
    assert cli["adapt"]["launches"] == {"forward": 3 * per_fwd, "backward": per_fwd}
    assert cli["predict"]["launches"] == {"forward": 2 * per_fwd, "backward": per_fwd}
    assert cli["predict"]["cases"] == 2
