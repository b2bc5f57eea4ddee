"""The 2D classifier backbones of the port (multimodal_tta_tpu_torch/models/
resnet.py, densenet.py, efficientnet.py, vit.py) against the flax ones on
the same variables (``models/convert.py:variables_from_flax``), the
pretrained porter (``models/pretrained.py``) against the reference's on the
same torchvision-named state dicts, and ``classifier_logits_apply``.

Tolerances (f32): logits and features within 1e-5 relative L2 in
inference mode and 3e-5 in training mode (the reference itself sits up to
1.5e-5 off an f64 run there, measured on these inputs: the late layers'
batch statistics pool 16 values per channel; the port 7.8e-6), running
statistics after a training forward within 1e-5 of each tensor's largest
value (tests/_torch_port.py:assert_stats_close), against flax; a ported
model's logits within 1e-4 of the torch model that wrote the state dict
(the bound of tests/test_backbones.py; 5e-4 for EfficientNet there too).
Inputs keep at least 16 values per channel in every BatchNorm: the f32
batch statistics of fewer are ill-conditioned in both packages
(tests/_torch_port.py:bn_unet_variables). The numbers are checked on one
member of each family at a small input, on ResNet-50's bottleneck block at
32x32, and on each MBConv layout; every registered name's parameter and
statistic tree in tests/test_torch_backbone_registry.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_tta_tpu.models  # noqa: F401 (registration)
import tests.test_backbones as jb  # torchvision-named torch models (a module import: pytest collects nothing here)
from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.models import efficientnet as jeff
from multimodal_tta_tpu.models import pretrained as jpre
from multimodal_tta_tpu.models.resnet import Bottleneck as JaxBottleneck
from multimodal_tta_tpu.registry import get_model as jax_get_model
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
from multimodal_tta_tpu_torch.models import efficientnet as teff
from multimodal_tta_tpu_torch.models import layers as tl
from multimodal_tta_tpu_torch.models.convert import variables_from_flax
from multimodal_tta_tpu_torch.models.pretrained import load_pretrained, load_torch_state_dict, to_torchvision
from multimodal_tta_tpu_torch.models.resnet import Bottleneck, ResNet
from multimodal_tta_tpu_torch.registry import get_model
from multimodal_tta_tpu_torch.tta import classifier_logits_apply, norm_param_mask
from tests._torch_port import assert_stats_close, flat_flax, meta_model, random_flax_params

torch.set_num_threads(2)

TINY_VIT = dict(image_size=32, patch=8, hidden=64, depth=2, heads=4, mlp_dim=128)
TINY_DENSENET = dict(growth_rate=8, block_config=(2, 2), init_features=16)


def _flax_variables(module, x_shape, seed: int):
    """``random_flax_params`` plus running statistics (mean near 0, var in
    [0.5, 2]) when the module has them."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(x_shape), train=True))
    v = {"params": random_flax_params(module, x_shape, seed)}
    if "batch_stats" in shapes:
        rng = np.random.RandomState(seed + 7)
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (0.3 * rng.randn(*a.shape) if str(getattr(p[-1], "key", "")) == "mean"
                          else rng.uniform(0.5, 2.0, a.shape)).astype(np.float32), shapes["batch_stats"])
    return v


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check(jm, tm, v, x, train: bool, outputs=2):
    """One forward of each (``outputs``: a (features, logits) pair or a
    block's one tensor, NHWC), and after a training forward the running
    statistics."""
    apply = jax.jit(lambda v, x: jm.apply(v, x, train=train, mutable=["batch_stats"] if train else False))
    out = apply(v, jnp.asarray(x))
    want = out[0] if train else out
    tm.load_state_dict(variables_from_flax(v), strict=True)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x) if outputs == 2 else torch.from_numpy(x).permute(0, 3, 1, 2))
    tm.eval()
    tol = 3e-5 if train else 1e-5
    if outputs == 2:
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert _rel(g.numpy(), w) <= tol, _rel(g.numpy(), w)
    else:
        assert _rel(got.permute(0, 2, 3, 1).numpy(), want) <= tol
    if train:
        new = variables_from_flax({"params": v["params"], "batch_stats": out[1]["batch_stats"]})
        assert assert_stats_close(tm.state_dict(), new) == len(tl.running_statistics(tm)) > 0


FAMILIES = {  # case: (registry name, flax / port overrides, config extras, batch, side)
    "resnet18": ("resnet18", {}, {}, 4, 64),
    "resnet18_reid": ("resnet18", {}, {"reid_mode": True, "embedding_dim": 32}, 8, 64),
    "densenet": ("densenet121", TINY_DENSENET, {}, 4, 64),
    "efficientnet_b0": ("efficientnet_b0", {}, {}, 4, 64),
    "vit": ("vit_b_16", TINY_VIT, {}, 2, 32),
}


@pytest.mark.parametrize("case,train", [(c, t) for c in sorted(FAMILIES) for t in (False, True)
                                        if not (c == "vit" and t)])  # the ViT has no BatchNorm
def test_family_matches_flax(case, train):
    name, over, extra, b, side = FAMILIES[case]
    cfg = {"name": name, "num_classes": 6, **extra}
    jm = jax_get_model(name).from_config(JaxConfigNode(cfg), **over)
    tm = get_model(name).from_config(ConfigNode(cfg), device="cpu", seed=None, **over)
    x = np.random.RandomState(1).randn(b, side, side, 3).astype(np.float32)
    _check(jm, tm, _flax_variables(jm, (1, side, side, 3), seed=2), x, train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("strides", [1, 2])
def test_resnet50_bottleneck_block(strides, train):
    """ResNet-50's bottleneck (64 -> 64 x 4 with the projection) at 32x32."""
    jm = JaxBottleneck(features=64, strides=strides)
    x = np.random.RandomState(3).randn(2, 32, 32, 64).astype(np.float32)
    _check(jm, Bottleneck(64, 64, strides), _flax_variables(jm, (1, 32, 32, 64), seed=4), x, train, outputs=1)


MBCONV = {  # (in, expand, out, stride, kernel, fused, eps): every block layout of the family
    "mb_e1_se": (16, 1, 16, 1, 3, False, 1e-5),
    "mb_e6_k5_s2": (16, 6, 24, 2, 5, False, 1e-5),
    "fused_e1": (24, 1, 24, 1, 3, True, 1e-3),
    "fused_e4_s2": (24, 4, 48, 2, 3, True, 1e-3),
    "v2_mb_e6": (48, 6, 48, 1, 3, False, 1e-3),
}


@pytest.mark.parametrize("case", sorted(MBCONV))
def test_mbconv_layouts(case):
    """Each MBConv / FusedMBConv layout (with the v2 eps 1e-3), in training
    mode: the block's output and its running statistics."""
    cin, e, cout, s, k, fused, eps = MBCONV[case]
    jm = jeff.MBConv(expand=e, features=cout, strides=s, kernel=k, fused=fused, bn_eps=eps)
    tm = teff.MBConv(cin, e, cout, s, k, fused, bn_eps=eps)
    x = np.random.RandomState(5).randn(2, 16, 16, cin).astype(np.float32)
    _check(jm, tm, _flax_variables(jm, (1, 16, 16, cin), seed=6), x, True, outputs=1)


def test_from_config_and_what_is_not_ported():
    m = get_model("efficientnet_v2_s").from_config(ConfigNode({"name": "efficientnet_v2_s", "num_classes": 3}),
                                                   device="cpu", remat=True)
    assert m.bn_eps == 1e-3 and all(b.epsilon == 1e-3 for b in m.modules() if isinstance(b, tl.BatchNorm))
    assert meta_model("resnet50", {}).variant == "resnet50"
    # tp_axis builds the blocks that a model axis cuts (tests/test_torch_tensor_parallel.py)
    assert meta_model("vit_b_16", {"tp_axis": "model"}).block0.MultiHeadDotProductAttention_0.tp_axis == "model"
    # the sequence axis builds (over ranks: tests/test_torch_sequence_axis.py)
    assert meta_model("vit_b_16", {"seq_shard_axis": "space"}).seq_shard_axis == "space"
    # moe_experts raised before the training-options slice: every second
    # block routes to its experts, as flax's ViT builds it
    moe_vit = meta_model("vit_b_16", {"moe_experts": 4})
    assert [i for i in range(12) if getattr(moe_vit, f"block{i}").num_experts] == [1, 3, 5, 7, 9, 11]
    assert moe_vit.block1.moe.wi.shape == (4, 768, 3072)
    vit = get_model("vit_b_16").from_config(ConfigNode({}), device="cpu", seed=0, **TINY_VIT)
    with pytest.raises(ValueError, match="patch count"):
        vit(torch.zeros(1, 48, 48, 3))
    with pytest.raises(ValueError, match="Unknown resnet variant"):
        ResNet(variant="resnet19", device="cpu")


def test_classifier_logits_apply_keeps_the_backbone_names():
    m = get_model("resnet18").from_config(ConfigNode({"num_classes": 4}), device="cpu", seed=0)
    w = classifier_logits_apply(m)
    assert [n for n, _ in w.named_parameters()] == [n for n, _ in m.named_parameters()]
    assert [n for n, _ in w.named_buffers()] == [n for n, _ in m.named_buffers()]
    assert all(a is b for a, b in zip(w.parameters(), m.parameters()))
    x = torch.randn(2, 32, 32, 3)
    with torch.no_grad():
        assert torch.equal(w(x), m(x)[1])
    assert norm_param_mask(w) == norm_param_mask(m)


# ---- pretrained ------------------------------------------------------------------
def _moved_bn(tnet, shape, seed):
    """Drive a torch model's BatchNorm statistics off their init, then eval."""
    torch.manual_seed(seed)
    tnet.train()
    with torch.no_grad():
        for _ in range(2):
            tnet(torch.randn(*shape))
    return tnet.eval()


PRETRAINED = {  # case: (registry name, torchvision-named torch model, overrides, classes, side)
    "resnet18": ("resnet18", lambda: jb.TestPretrainedPort._torch_resnet18(num_classes=10), {}, 10, 32),
    "densenet": ("densenet121", lambda: jb.TestPretrainedPort._torch_densenet(), TINY_DENSENET, 5, 32),
    "vit": ("vit_b_16", lambda: jb.TestPretrainedPort._torch_vit(), TINY_VIT, 5, 32),
    "efficientnet_b0": ("efficientnet_b0", lambda: jb.TestPretrainedPort._torch_efficientnet(
        "efficientnet_b0", num_classes=7), {}, 7, 64),
}


@pytest.mark.parametrize("case", sorted(PRETRAINED))
def test_pretrained_matches_the_reference_porter(case, tmp_path):
    """One torchvision-named state dict (tests/test_backbones.py's torch
    models, statistics moved off their init), read by the reference's
    porter into flax and by the port's loader: the same logits, and the
    torch model's own; ``to_torchvision`` writes the file back bitwise."""
    name, make, over, classes, side = PRETRAINED[case]
    torch.manual_seed(0)
    tnet = _moved_bn(make(), (2, 3, side, side), seed=1)
    path = str(tmp_path / "sd.pt")
    torch.save(tnet.state_dict(), path)
    x = torch.randn(2, 3, side, side)
    with torch.no_grad():
        want = tnet(x).numpy()
    xh = x.permute(0, 2, 3, 1).numpy()

    jm = jax_get_model(name).from_config(JaxConfigNode({"name": name, "num_classes": classes}), **over)
    v = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)), train=True)))
    heads = over.get("heads")
    ported = (jpre.port_torch_vit(load_torch_state_dict(path), heads=heads) if name.startswith("vit")
              else jpre.port_pretrained_variables(name, path))
    v = jpre.apply_pretrained(v, ported, name)
    jlogits = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False)[1])(v, jnp.asarray(xh)))

    if not over:  # through the entry point a user calls
        cfg = {"task": {"name": "imagenet", "seed": 0}, "training": {"compute_dtype": "float32"},
               "model": {"name": name, "num_classes": classes, "pretrained": True, "pretrained_source": path}}
        tm = ExperimentManager(ConfigNode(cfg), device="cpu").setup_model()
    else:
        tm = get_model(name).from_config(ConfigNode({"num_classes": classes}), device="cpu", **over)
        load_pretrained(tm, name, path)
    with torch.no_grad():
        got = tm(torch.from_numpy(xh))[1].numpy()
    assert _rel(got, jlogits) <= 1e-5
    np.testing.assert_allclose(got, want, rtol=5e-4 if "efficient" in name else 1e-4,
                               atol=5e-4 if "efficient" in name else 1e-4)
    back = to_torchvision(tm, name)
    sd = {k: t for k, t in tnet.state_dict().items()}
    assert set(back) == set(sd)
    assert all(torch.equal(back[k].float(), sd[k].float()) for k in sd if not k.endswith("num_batches_tracked"))


def test_pretrained_error_cases(tmp_path, monkeypatch):
    m = get_model("resnet18").from_config(ConfigNode({"num_classes": 4}), device="cpu", seed=0)
    sd = to_torchvision(m, "resnet18")
    ok = tmp_path / "ok.pt"
    torch.save({"state_dict": sd}, ok)  # a checkpoint dict carrying the state dict
    assert set(load_torch_state_dict(str(ok))) == set(sd)
    bad_shape = dict(sd, **{"fc.weight": torch.zeros(5, 512), "fc.bias": torch.zeros(5)})
    torch.save(bad_shape, tmp_path / "shape.pt")
    with pytest.raises(ValueError, match="shape mismatch at fc.weight"):
        load_pretrained(m, "resnet18", str(tmp_path / "shape.pt"))
    torch.save(dict(sd, **{"layer9.0.conv1.weight": torch.zeros(1)}), tmp_path / "extra.pt")
    with pytest.raises(ValueError, match="1 tensors of .* have no home in the model"):
        load_pretrained(m, "resnet18", str(tmp_path / "extra.pt"))
    no_head = {k: t for k, t in sd.items() if not k.startswith("fc.")}
    torch.save(no_head, tmp_path / "nohead.pt")
    logged = []
    from multimodal_tta_tpu_torch.models import pretrained as tpre

    monkeypatch.setattr(tpre.get_logger(), "info", logged.append)
    fresh = get_model("resnet18").from_config(ConfigNode({"num_classes": 4}), device="cpu", seed=5)
    fc = fresh.fc.weight.detach().clone()
    load_pretrained(fresh, "resnet18", str(tmp_path / "nohead.pt"))
    assert torch.equal(fresh.fc.weight, fc) and torch.equal(fresh.stem.weight, m.stem.weight)
    assert any("2 leaves stay at random init" in s and "fc.weight" in s for s in logged)
    torch.save([1, 2], tmp_path / "list.pt")
    with pytest.raises(ValueError, match="does not contain a state_dict"):
        load_torch_state_dict(str(tmp_path / "list.pt"))
    with pytest.raises(NotImplementedError, match="no torchvision porter exists for model family 'unet'"):
        load_pretrained(get_model("unet").from_config(ConfigNode({"channels": [4, 8], "strides": [2]}), device="cpu"),
                        "unet", str(ok))
    cfg = {"task": {"name": "imagenet", "seed": 0}, "model": {"name": "resnet18", "pretrained": True}}
    with pytest.raises(ValueError, match="pretrained_source is not set"):
        ExperimentManager(ConfigNode(cfg), device="cpu").setup_model()


def test_flax_paths_of_a_classifier():
    """``from_flax`` carries 2D, depthwise and grouped kernels (HWIO ->
    OIHW) and ``variables_from_flax`` the statistics; names are flax's."""
    jm = jeff.MBConv(expand=6, features=24, strides=2, kernel=5)
    v = _flax_variables(jm, (1, 8, 8, 16), seed=8)
    sd = variables_from_flax(v)
    flat = flat_flax(v["params"])
    dw = flat["Conv_1/kernel"]
    assert dw.shape == (5, 5, 1, 96) and tuple(sd["Conv_1.weight"].shape) == (96, 1, 5, 5)
    np.testing.assert_array_equal(sd["Conv_1.weight"].numpy(), dw.transpose(3, 2, 0, 1))
    assert set(k for k in sd if k.endswith((".mean", ".var"))) == {f"BatchNorm_{i}.{s}" for i in range(3)
                                                                   for s in ("mean", "var")}
