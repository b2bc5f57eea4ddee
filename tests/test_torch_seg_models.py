"""Parity of the port's convolutional 3D segmentation models with the flax
ones (multimodal_tta_tpu_torch/models/: mid- and late-fusion UNets,
UNet3D-WS, SegResNet; the new layers; remat; the weight bridge), the same
flax params carried across by ``models/convert.py:from_flax``.

Tolerances:
  - logits in f32: max abs 1e-4; in bf16: relative L2 5e-2 (the bound of
    tests/test_torch_unet3d.py: convs round at other places in XLA and
    oneDNN, and the norms re-amplify each rounding);
  - mid-fusion domain logits and intermediate features: max abs 1e-4;
  - UpSample and Norm GROUP / LAYER / NONE: max abs 1e-5;
  - remat: gradients with and without it within 1e-6 relative (the same
    ops, recomputed), and against ``jax.grad`` of the reference with remat
    on within 1e-3 relative L2 over all parameters (the bound ROADMAP.md §3
    keeps for parameter deltas: f32 sums in another order), 5e-3 for
    SegResNet: there the reference's own f32 gradient is 1.6e-3 off the
    exact one (flax's GroupNorm takes the variance as E[x^2] - E[x]^2 on a
    residual stream with a large mean), while the port's is 9e-7 off its
    f64 run (both measured on this test's input).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.models import layers as jl
from multimodal_tta_tpu.models.segresnet import SegResNet as JaxSegResNet
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu.models.unet3d_ws import UNet3DWS as JaxUNet3DWS
from multimodal_tta_tpu.models.unet_multimodal_latefusion import MultimodalUNetLateFusion as JaxLate
from multimodal_tta_tpu.models.unet_multimodal_midfusion import MultimodalUNetMidFusion as JaxMid
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.models import layers as tl
from multimodal_tta_tpu_torch.models import (
    MultimodalUNetLateFusion,
    MultimodalUNetMidFusion,
    SegResNet,
    UNet3D,
    UNet3DWS,
)
from multimodal_tta_tpu_torch.models.convert import flax_path, from_flax, unet3d_from_flax
from multimodal_tta_tpu_torch.registry import get_model
from multimodal_tta_tpu_torch.tta.tent import norm_param_mask
from tests._torch_port import flat_flax, np_params, random_flax_params, randomize, to_ncdhw, to_ndhwc

torch.set_num_threads(1)

SMALL = dict(channels=(4, 8, 16, 32, 64), strides=(2, 2, 2, 2), num_res_units=2)
FULL = dict(channels=(32, 64, 128, 256, 512), strides=(2, 2, 2, 2), num_res_units=2)
# (flax class, port class, small kwargs, full-width kwargs, tensors, norm affines)
MODELS = {
    "midfusion": (JaxMid, MultimodalUNetMidFusion, dict(num_modalities=4, num_classes=3, **SMALL),
                  dict(num_modalities=4, num_classes=3, **FULL), 208, 98),
    "latefusion": (JaxLate, MultimodalUNetLateFusion, dict(num_modalities=4, num_classes=3, **SMALL),
                   dict(num_modalities=4, num_classes=3, **FULL), 328, 144),
    "unet_ws": (JaxUNet3DWS, UNet3DWS, dict(in_channels=4, num_classes=3, **SMALL),
                dict(in_channels=4, num_classes=3, **FULL), 70, 32),
    "segresnet": (JaxSegResNet, SegResNet, dict(in_channels=4, num_classes=3, init_filters=4),
                  dict(in_channels=4, num_classes=3), 83, 50),
}
SHAPE = (2, 16, 16, 16, 4)


def _x(shape=SHAPE, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def small_params():
    return {name: random_flax_params(j(**kw), SHAPE, seed=i + 1)
            for i, (name, (j, _, kw, *_rest)) in enumerate(MODELS.items())}


def _port(name, params, **kw):
    _, t, small, *_ = MODELS[name]
    m = t(**{**small, **kw}, device="cpu")
    m.load_state_dict(from_flax(params), strict=True)
    return m


def _jax_apply(name, params, x, **call):
    j, _, small, *_ = MODELS[name]
    jm = j(**small, dtype=call.pop("dtype", jnp.float32))
    return jax.jit(lambda p, a: jm.apply({"params": p}, a, **call))(params, jnp.asarray(x))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_f32(small_params, name):
    x = _x(seed=3)
    want = np.asarray(_jax_apply(name, small_params[name], x))
    with torch.no_grad():
        got = _port(name, small_params[name])(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == SHAPE[:4] + (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_bf16(small_params, name):
    x = _x(seed=4)
    want = np.asarray(_jax_apply(name, small_params[name], x, dtype=jnp.bfloat16), np.float32)
    with torch.no_grad():
        got = _port(name, small_params[name], dtype=torch.bfloat16)(torch.from_numpy(x)).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 5e-2, rel


def test_midfusion_domain_logits_and_features(small_params):
    """Domain logits [M*B, M], row m*B + b, and the intermediate features."""
    p, x = small_params["midfusion"], _x(seed=5)
    w_logits, w_dom = _jax_apply("midfusion", p, x, return_domain_logits=True)
    _, w_shared, w_spec = _jax_apply("midfusion", p, x, return_intermediate_features=True)
    m = _port("midfusion", p)
    with torch.no_grad():
        logits, dom = m(torch.from_numpy(x), return_domain_logits=True)
        _, shared, spec = m(torch.from_numpy(x), return_intermediate_features=True)
    assert tuple(dom.shape) == (8, 4) and dom.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(w_logits), atol=1e-4)
    np.testing.assert_allclose(dom.numpy(), np.asarray(w_dom), atol=1e-4)
    # row m*B + b is modality m's global feature of sample b
    glob = [torch.from_numpy(np.array(g)) for g in w_spec]
    direct = m.domain_classifier(torch.cat(glob, dim=0))
    np.testing.assert_allclose(dom.numpy(), direct.detach().numpy(), atol=1e-5)
    assert len(shared) == len(spec) == len(w_shared) == len(w_spec) == 4
    for a, b in zip(shared + spec, list(w_shared) + list(w_spec)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    off = MultimodalUNetMidFusion(**MODELS["midfusion"][2], domain_enabled=False, device="cpu")
    assert off.domain_classifier is None and off.get_domain_loss_weight() == 0.0
    assert m.get_domain_loss_weight() == pytest.approx(0.1)
    with torch.no_grad():
        assert off(torch.from_numpy(x), return_domain_logits=True).shape == SHAPE[:4] + (3,)


def _port_shape(path: str, shape: tuple) -> tuple:
    """The port's shape of a flax leaf (the layouts of convert.py)."""
    if path.endswith("kernel") and len(shape) == 5:
        return (shape[4], shape[3]) + shape[:3] if not path.endswith("/up/kernel") else \
            (shape[3], shape[4]) + shape[:3]
    if path.endswith("kernel") and len(shape) == 2:
        return (shape[1], shape[0])
    return shape


# UNet3D-WS at the flagship's 2 inputs has a stem projection (16 -> 32
# channels); at BraTS's 4 the packed input already has 32 channels, so none
TREES = [(name, {}) + MODELS[name][4:] for name in ("midfusion", "latefusion", "segresnet")] + [
    ("unet_ws", {"in_channels": 2}, 72, 32), ("unet_ws", {}, 70, 32)]


@pytest.mark.parametrize("name,kw,n_tensors,n_norm", TREES)
def test_param_tree_matches_flax_at_config_widths(name, kw, n_tensors, n_norm):
    """Names, shapes and counts at the config widths (the flax tree from
    ``jax.eval_shape``, nothing compiled), and the norm affines Tent adapts."""
    j, t, _, full, *_ = MODELS[name]
    full = {**full, **kw}
    c_in = full.get("in_channels", 4)
    shapes = jax.eval_shape(lambda: j(**full).init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, c_in))))
    want = {flax: _port_shape(flax, tuple(v.shape)) for flax, v in flat_flax(shapes["params"]).items()}
    m = t(**full, device="cpu", seed=None)
    got = {flax_path(n): tuple(p.shape) for n, p in m.named_parameters()}
    assert got == want
    assert len(got) == n_tensors
    assert sum(norm_param_mask(m).values()) == n_norm


@pytest.mark.parametrize("name", sorted(MODELS))
def test_weight_bridge_round_trip(small_params, name):
    """from_flax, then back to flax through flax_path, name by name: every
    leaf returns bitwise (the dense kernel transposed, conv kernels
    permuted, a transposed conv's kernel flipped back)."""
    flat = flat_flax(small_params[name])
    m = _port(name, small_params[name])
    back = {}
    for n, p in m.state_dict().items():
        a = p.numpy()
        path = flax_path(n)
        if path.endswith("kernel") and a.ndim == 2:
            a = a.T
        elif path.endswith("/up/kernel"):
            a = a.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]
        elif path.endswith("kernel"):
            a = a.transpose(2, 3, 4, 1, 0)
        back[path] = a
    assert set(back) == set(flat)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(back[path], np.asarray(leaf), err_msg=path)
    assert unet3d_from_flax is from_flax


@pytest.mark.parametrize("scale,in_ch,feat", [(2, 6, 4), ((1, 2, 2), 3, 3), (1, 5, 2)])
def test_upsample(scale, in_ch, feat):
    x = _x((2, 3, 4, 5, in_ch), seed=6)
    jm = jl.UpSample(features=feat, scale=scale)
    params = randomize(np_params(jm, x), 11) if in_ch != feat else {}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tl.UpSample(in_ch, feat, scale)
    if params:
        tm.load_state_dict(from_flax(params), strict=True)
    assert (tm.proj is None) == (in_ch == feat)
    with torch.no_grad():
        got = to_ndhwc(tm(to_ncdhw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("kind,c", [("GROUP", 16), ("GROUP", 12), ("GROUP", 6), ("LAYER", 5), ("NONE", 3)])
def test_norm_kinds(kind, c):
    """GROUP takes gcd(8, C) groups (4 for C=12, 2 for C=6), LAYER the
    channels; both with 1-D scale / bias that Tent's structural mask picks."""
    x = _x((2, 3, 4, 5, c), seed=7) * 2 + 1
    jm = jl.Norm(kind)
    params = randomize(np_params(jm, x), 12) if kind != "NONE" else {}
    want = np.asarray(jm.apply({"params": params} if params else {}, jnp.asarray(x)))
    tm = tl.Norm(kind, c)
    if params:
        tm.load_state_dict(from_flax(params), strict=True)
        assert all(norm_param_mask(tm).values()) and len(norm_param_mask(tm)) == 2
    else:
        assert not list(tm.parameters())
    with torch.no_grad():
        got = to_ndhwc(tm(to_ncdhw(x)))
        relu = to_ndhwc(tm(to_ncdhw(x), relu=True))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(relu, np.maximum(want, 0), atol=1e-5)
    with torch.no_grad():
        y16 = tm(to_ncdhw(x).to(torch.bfloat16))
    assert y16.dtype == torch.bfloat16


def test_stale_messages_name_the_roadmap_item_and_the_reference():
    # BATCH is ported (it raised naming item 11 before the BatchNorm slice):
    # the norm is the reference's BatchNorm, with running statistics
    bn = tl.Norm("BATCH", 4).norm
    assert isinstance(bn, tl.BatchNorm) and bn.epsilon == 1e-5 and bn.momentum == 0.9
    assert sorted(n for n, _ in bn.named_parameters()) == ["bias", "scale"]
    assert sorted(n for n, _ in bn.named_buffers()) == ["mean", "var"]
    m = UNet3D(in_channels=2, num_classes=1, dropout=0.1, device="cpu", **SMALL)
    with pytest.raises(NotImplementedError, match="reference cannot train with dropout"):
        m.train()
        m(torch.zeros(1, 16, 16, 16, 2))


@pytest.mark.parametrize("name", ["unet", "midfusion", "segresnet"])
def test_dropout_is_the_identity_outside_training(small_params, name):
    """A model built with dropout equals the reference's train=False apply
    (the identity), in the port's default inference mode."""
    x = _x(seed=8)
    if name == "unet":
        jm = JaxUNet3D(in_channels=4, num_classes=3, dropout=0.2, **SMALL)
        params = random_flax_params(jm, SHAPE, seed=9)
        tm = UNet3D(in_channels=4, num_classes=3, dropout=0.2, device="cpu", **SMALL)
        tm.load_state_dict(from_flax(params), strict=True)
    else:
        j, t, small, *_ = MODELS[name]
        jm, params = j(**small, dropout=0.2), small_params[name]
        tm = _port(name, params, dropout=0.2)
    want = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a, train=False))(params, jnp.asarray(x)))
    assert not tm.training
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _norm_calls(model):
    calls = [0]
    hooks = [m.register_forward_pre_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
             for m in model.modules() if isinstance(m, tl.InstanceNorm)]
    return calls, hooks


# (model, remat, norm calls of one forward, of them rematerialized, rel L2
# bound against the reference's gradient)
REMAT_CASES = [("unet", True, 18, 18, 1e-3), ("unet", 2, 18, 8, 1e-3), ("midfusion", True, 52, 52, 1e-3),
               ("latefusion", True, 72, 72, 1e-3), ("segresnet", 2, 0, 0, 5e-3)]


@pytest.mark.parametrize("name,remat,per_forward,recomputed,rel", REMAT_CASES)
def test_remat_changes_no_gradient(small_params, name, remat, per_forward, recomputed, rel):
    """f32 gradients of a loss over the logits: remat against none within
    1e-6 relative, and against jax.grad of the reference with remat on; a
    rematerialized norm runs its forward again in the backward. [1,32,32,32]
    volumes, so that the deepest norm has 8 voxels: over one voxel its
    variance is 0 and rsqrt(eps) amplifies rounding noise 316-fold."""
    shape = (1, 32, 32, 32, 4)
    x = _x(shape, seed=10)
    w = np.random.RandomState(11).randn(*shape[:4], 3).astype(np.float32)
    if name == "unet":
        kw = dict(in_channels=4, num_classes=3, **SMALL)
        j, params = JaxUNet3D, random_flax_params(JaxUNet3D(**kw), SHAPE, seed=12)
        make = lambda r: UNet3D(**kw, remat=r, device="cpu")  # noqa: E731
    else:
        j, t, kw, *_ = MODELS[name]
        params = small_params[name]
        make = lambda r: t(**kw, remat=r, device="cpu")  # noqa: E731
    grads, calls = {}, {}
    for r in (False, remat):
        m = make(r)
        m.load_state_dict(from_flax(params), strict=True)
        count, hooks = _norm_calls(m)
        loss = (m(torch.from_numpy(x)) * torch.from_numpy(w)).sum()
        loss.backward()
        calls[r] = count[0]
        for h in hooks:
            h.remove()
        grads[r] = {flax_path(n): torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                    for n, p in m.named_parameters()}  # the domain head gets no gradient
    assert calls[False] == per_forward and calls[remat] == per_forward + recomputed
    for n, g in grads[False].items():
        scale = float(g.abs().max()) or 1.0
        assert float((grads[remat][n] - g).abs().max()) <= 1e-6 * scale, n

    jm = j(**kw, remat=remat)
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x), train=True)
                                               * jnp.asarray(w))))(jax.tree_util.tree_map(jnp.asarray, params))
    want = from_flax(jax.tree_util.tree_map(np.asarray, jgrad))
    assert {flax_path(n) for n in want} == set(grads[remat])
    ref = torch.cat([g.flatten() for g in want.values()])
    got = torch.cat([grads[remat][flax_path(n)].flatten() for n in want])
    assert float((got - ref).norm() / ref.norm()) <= rel


NAMES = {"unet_multimodal_midfusion": MultimodalUNetMidFusion, "unet_multimodal_deepfusion": MultimodalUNetMidFusion,
         "unet_multimodal_mid": MultimodalUNetMidFusion, "unet_multimodal_late": MultimodalUNetLateFusion,
         "unet_multimodal_latefusion": MultimodalUNetLateFusion, "unet_ws": UNet3DWS, "segresnet": SegResNet,
         "unet": UNet3D}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_registry_builds_each_name_with_remat(name, monkeypatch):
    """get_model(name).from_config(cfg, dtype=, remat=, device=, seed=), as
    ExperimentManager.setup_model calls it; training.remat=true does not
    raise; the default device is cuda, which raises without a card."""
    cfg = ConfigNode({"num_modalities": 4, "in_channels": 4, "num_classes": 3, "channels": list(SMALL["channels"]),
                      "strides": [2, 2, 2, 2], "num_res_units": 2, "init_filters": 4})
    cls = get_model(name)
    assert cls is NAMES[name]
    m = cls.from_config(cfg, dtype=torch.bfloat16, remat=True, device="cpu", seed=3)
    again = cls.from_config(cfg, dtype=torch.bfloat16, remat=True, device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), again.parameters()))
    assert not m.training
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls.from_config(cfg, remat=True)
