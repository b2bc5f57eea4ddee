"""The CNN classifiers over a split image height (``models/resnet.py``,
``models/densenet.py``, ``models/efficientnet.py``; ``parallel/space.py``'s
height rule): four gloo ranks on the CPU, on ``data=1 x space=4`` and on
``data=2 x space=2``, against the one-process port on the same global
batches, and against the JAX package on a ``data=1 x space=2`` mesh of its
CPU devices.

One spawn (``tests/_torch_st_worker.py``, which imports no JAX) runs every
case on both meshes in the four ranks and once in one more process without
a mesh, while the JAX references run in threads here. It also runs the
ulp pins of the whole params over a model and an expert group.

The fixtures, at 64 x 64 (16 images; each family's last level is 2 x 2, so
every BatchNorm sees at least 64 values a channel):

  * ResNet-18: the 7x7/2 stem, the max-pool at a slab edge, layer2's 3x3/2
    and its 1x1/2 downsample split on both meshes; layer3 is whole over
    ``space=4`` (a 2-row slab does not halve into 2 rows), layer4 over
    ``space=2``;
  * DenseNet-121 shrunk (``growth_rate`` 8, ``block_config`` (2, 2, 2, 2),
    ``init_features`` 16): the transitions' 2x2 average pools split until
    the second (``space=4``) or the third (``space=2``), which is gathered;
  * EfficientNet-B0: stage 2's 5x5/2 depthwise convs and every
    squeeze-excitation before them split; stage 3 (``space=4``) or stage 5
    (``space=2``) is gathered;
  * EfficientNet-V2-S (FusedMBConv): a training-mode forward and its
    gradients over ``data=2 x space=2``, where 26 of its 40 blocks split.

Tolerances against one process: logits and a forward's summed gradients
within 1e-5 relative L2; the adapted BatchNorm affines within 1e-5
relative plus 2e-6; running statistics within 1e-5 of each tensor's
largest value; entropies within 1e-5 relative; predictions equal. Against
the JAX package (Tent's step on each of the three families):
``tests/test_torch_tta_classification.py``'s bounds, the moves within 1e-3
relative L2 and the statistics within 3e-5. ``WIDE`` lists the cases
computed in f64, and why.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import multimodal_tta_tpu.tta  # noqa: F401  (every method registered before the reference's threads look one up)
from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_tta_tpu.parallel.mesh import shard_batch as jax_shard_batch
from multimodal_tta_tpu.registry import get_model as jax_get_model
from multimodal_tta_tpu.registry import get_tta_method as jax_get_tta_method
from multimodal_tta_tpu.tta.engine import classifier_logits_apply as jax_classifier_logits_apply
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.models.convert import variables_from_flax
from multimodal_tta_tpu_torch.parallel import space as sp
from multimodal_tta_tpu_torch.registry import get_model

from _torch_port import (ADAM, DEVICE_TRANSFORM, assert_stats_close, jax_state, random_flax_params, trainer_config,
                         tta_config)
from _torch_st_worker import MESHES, spawn

SIDE, BATCH, CLASSES = 64, 16, 10
LAYOUTS = ("s4", "d2s2")
FAMILIES = {  # key: (registry name, topology overrides, flax seed)
    "resnet18": ("resnet18", {}, 3),
    "densenet": ("densenet121", dict(growth_rate=8, block_config=(2, 2, 2, 2), init_features=16), 62),
    "b0": ("efficientnet_b0", {}, 63),
    "v2s": ("efficientnet_v2_s", {}, 64),
}
ADAPTED = ("resnet18", "densenet", "b0")  # every adapter; V2-S: a forward
# computed in f64 (the compute dtype; the params and statistics stay f32):
# ResNet-18's forward gradients and Tent, since at this size some
# pre-activation of a ReLU lies within f32 rounding of the kink, and any two
# summation orders (one process against itself on its batch's rows
# reversed: up to 2.2e-3 on 4 of 6 image seeds) move its gradients that
# far; V2-S's forward, whose f32 logits sit 1.0e-5 from one process after
# 40 blocks; DenseNet's Tent, whose f32 moves sit 1.2e-3 from the
# reference's f32 run (tests/test_torch_tta_classification.py's rule then
# holds them to the port's f64 run)
WIDE = {"resnet18": ("forward", "tent"), "densenet": ("tent",), "v2s": ("forward",)}
KNOBS = {
    "tent": dict(),
    "pl": dict(pl={"conf_threshold": 0.2}),
    "eata": dict(reliability={"margin_ratio": 1.0}, fisher={"batches": 1, "lambda": 50.0}),
    "sar": dict(lr=0.2, rho=0.5, margin_ratio=1.0),
    "cotta": dict(ema=0.9, n_views=2, restore={"enabled": True, "prob": 0.2}),
    "memo": dict(n_views=2, serve="marginal"),
}
# the levels each fixture's ops read, split (True) or whole, from row_ops
# over each mesh's space axis (test_fixture_levels)
LEVELS = {
    ("resnet18", 4): [True] * 6 + [False] * 4, ("resnet18", 2): [True] * 8 + [False] * 2,
    ("densenet", 4): [True] * 7 + [False] * 6, ("densenet", 2): [True] * 10 + [False] * 3,
    ("b0", 4): [True] * 6 + [False] * 11, ("b0", 2): [True] * 12 + [False] * 5,
}
ULP_UNETR = dict(in_channels=2, num_classes=1, patch_size=8, hidden_size=16, mlp_dim=32, num_heads=2, num_layers=3,
                 feature_size=4, image_size=(16, 16, 16))
ULP_AXES = {"d2m2": dict(ULP_UNETR, tp_axis="model"), "d2e2": dict(ULP_UNETR, moe_experts=2)}


def _cfg(method: str, **tta) -> dict:
    cfg = tta_config(method, softmax=True, **dict(dict(steps=1, lr=0.1, episodic=False), **tta))
    cfg["training"]["compute_dtype"] = "float32"
    return cfg


def _flax(key: str):
    """The reference's module and variables of a family: ``random_flax_params``
    and running statistics (mean near 0, var in [0.5, 2])."""
    name, over, seed = FAMILIES[key]
    jm = jax_get_model(name).from_config(JaxConfigNode({"name": name, "num_classes": CLASSES}), **over)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)), train=True))
    rng = np.random.RandomState(seed + 7)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.3 * rng.randn(*a.shape) if str(getattr(p[-1], "key", "")) == "mean"
                      else rng.uniform(0.5, 2.0, a.shape)).astype(np.float32), shapes["batch_stats"])
    return jm, {"params": random_flax_params(jm, (1, SIDE, SIDE, 3), seed), "batch_stats": stats}


def _images(seed: int, n: int = 2):
    rng = np.random.RandomState(seed)
    return [(1.5 * rng.randn(BATCH, SIDE, SIDE, 3) + 0.3).astype(np.float32) for _ in range(n)]


def _payloads(variables: dict) -> dict:
    out = {}
    for key, (name, over, seed) in FAMILIES.items():
        base = dict(name=name, model_kw=dict(over, variant=name, num_classes=CLASSES),
                    state=variables_from_flax(variables[key]))
        wide = dict(base, model_kw=dict(base["model_kw"], dtype=torch.float64))
        x = _images(seed)
        w = np.random.RandomState(seed + 1).randn(BATCH, CLASSES).astype(np.float32)
        # V2-S's 40 blocks on the mesh that splits 26 of them
        out[f"{key}_forward"] = ("classifier", LAYOUTS if key in ADAPTED else ("d2s2",),
                                 dict(wide if "forward" in WIDE.get(key, ()) else base, x=x[0], w=w))
        for method in KNOBS if key in ADAPTED else ():
            # one ragged batch (15 valid rows of 16), online: on the CPU ranks
            # every forward costs its gloo collectives (~1-2 ms each)
            out[f"{key}_{method}"] = ("adapter", LAYOUTS, dict(
                wide if method in WIDE.get(key, ()) else base, cfg=_cfg(method, **KNOBS[method]),
                batches=x[1:], n_valid=[BATCH - 1], classifier=True, threshold=0.5, predict_mode="inline"))
        if key in ADAPTED:
            out[f"{key}_norm"] = ("classifier_norm", LAYOUTS, dict(base, cfg=_cfg("norm"), batches=x,
                                                                  n_valid=[BATCH, BATCH - 1]))
    for mesh, kw in ULP_AXES.items():
        state = get_model("unetr")(**kw, device="cpu", seed=5).state_dict()
        rng = np.random.RandomState(7)
        vols = [(rng.randn(4, 16, 16, 16, 2) * 100).astype(np.float32) for _ in range(2)]
        labels = [(rng.rand(4, 16, 16, 16, 1) > 0.7).astype(np.float32) for _ in range(2)]
        train = trainer_config(ADAM, model={k: v for k, v in kw.items() if k != "image_size"})
        out[f"ulp_train_{mesh}"] = ("ulp", mesh, dict(
            kind="train", cfg=train, name="unetr", model_kw=kw, state=state, device_transform=DEVICE_TRANSFORM,
            batches=[{"image": v, "label": y} for v, y in zip(vols, labels)]))
        tent = dict(tta_config("tent", steps=1, lr=1e-2, episodic=False, optimizer="adam"),
                    training={"criterion": {"sigmoid": True}, "compute_dtype": "float32"})
        out[f"ulp_tent_{mesh}"] = ("ulp", mesh, dict(
            kind="tent", cfg=tent, name="unetr", model_kw=kw, state=state, device_transform=DEVICE_TRANSFORM,
            batches=vols))
    return out


def _jax_tent(key: str, jm, variables: dict, payload: dict):
    """The JAX Tent adapter on the family's logits on a ``data=1 x space=2``
    mesh of the CPU devices, in the port case's mode on its batch: the
    adapted variables (as the port's state dict) and the predictions."""
    cfg = JaxConfigNode(payload["cfg"])
    mesh = jax_make_mesh(jax.devices()[:2], data=1, space=2)
    state = jax_state(variables["params"], module=jm, batch_stats=variables["batch_stats"],
                      apply_fn=jax_classifier_logits_apply(jm))
    with mesh:
        adapter = jax_get_tta_method("tent")(cfg.tta, config=cfg, mesh=mesh)
        fn = adapter.make_adapt_predict_fn(state, threshold=0.5, predict_mode=payload["predict_mode"])
        x = payload["batches"][0]
        cur, pred = fn(state, jax_shard_batch({"image": x}, mesh)["image"], payload["n_valid"][0])
        ents = np.asarray(adapter._last_ents)
    new = variables_from_flax({"params": jax.device_get(cur.params), "batch_stats": jax.device_get(cur.batch_stats)})
    return new, ents, np.asarray(pred)


class _Runs:
    def __init__(self, tmp: str):
        flax = {k: _flax(k) for k in FAMILIES}
        self.payloads = _payloads({k: v for k, (_, v) in flax.items()})
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.future = self.pool.submit(spawn, list(self.payloads.values()), tmp, 400)
        self.jax_pool = concurrent.futures.ThreadPoolExecutor(3)
        self.jax = {k: self.jax_pool.submit(_jax_tent, k, *flax[k], self.payloads[f"{k}_tent"][2]) for k in ADAPTED}

    def __getitem__(self, name):
        ranks, one = self.future.result()
        i = list(self.payloads).index(name)
        return self.payloads[name][2], [r[i] for r in ranks], one[i]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(str(tmp_path_factory.mktemp("sc")))
    yield r
    r.pool.shutdown()
    r.jax_pool.shutdown()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _affines(state: dict) -> list:
    return sorted(k for k in state if k.rpartition(".")[2] in ("scale", "bias") and (
        "BatchNorm" in k or "bn" in k.rpartition(".")[0].rpartition(".")[2]))


def _moves(got: dict, want: dict, source: dict) -> float:
    names = _affines(want)
    return _rel(np.concatenate([(got[n] - source[n]).ravel() for n in names]),
                np.concatenate([(want[n] - source[n]).ravel() for n in names]))


def _stats_close(got: dict, want: dict, rel: float = 1e-5) -> int:
    return assert_stats_close({k: torch.as_tensor(v) for k, v in got.items()},
                              {k: torch.as_tensor(v) for k, v in want.items()}, rel=rel)


def _source(payload: dict) -> dict:
    return {k: v.numpy() for k, v in payload["state"].items()}


# ---------------------------------------------------------------------------


class _Axis:
    def __init__(self, size: int):
        self.size = size


@pytest.mark.parametrize("key,size", sorted(LEVELS))
def test_fixture_levels(key, size):
    """Each fixture's ops over 2 and 4 space ranks (``space.row_axes`` on
    its ``row_ops``): a run of split levels, then whole ones from the first
    op that breaks the height rule; the layer kinds the cases rest on."""
    name, over, _ = FAMILIES[key]
    m = get_model(name).from_config(ConfigNode({"num_classes": CLASSES}), device="cpu", seed=None, **over)
    got = [a is not None for a in sp.row_axes(_Axis(size), SIDE // size, m.row_ops)]
    assert got == LEVELS[(key, size)]
    first_whole = got.index(False)
    stride = m.row_ops[first_whole][0]
    assert stride == 2 and (SIDE // size) // np.prod([s for s, _ in m.row_ops[:first_whole]]) in (1, 2)


@pytest.mark.parametrize("k,s,p,rows", [(7, 2, 3, 16), (3, 2, 1, 8), (1, 2, 0, 8), (5, 2, 2, 4), (5, 1, 2, 2),
                                        (3, 1, 1, 2)])
def test_row_halos_give_the_whole_conv(k, s, p, rows):
    """``row_halos`` against ``F.conv2d`` on the whole image: each of 4
    slabs of ``rows`` rows with its neighbours' rows (zeros past the image)
    and no padding along H gives its rows of the whole conv's output, for
    the stem's 7x7/2/3, a 3x3/2/1, the 1x1/2 downsample and 5x5 / 3x3
    depthwise at strides 2 and 1; the max-pool likewise with -inf."""
    rng = np.random.RandomState(k * 10 + s)
    x = torch.from_numpy(rng.randn(2, 3, 4 * rows, 10).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 1, k, k).astype(np.float32))
    lo, hi = sp.row_halos(k, s, p)
    assert lo == p and hi == max(k - s - p, 0)
    whole = F.conv2d(x, w, stride=s, padding=p, groups=3)
    pooled = F.max_pool2d(x, 3, 2, 1)
    padded = F.pad(x, (0, 0, lo, hi))
    ninf = F.pad(x, (0, 0, 1, 0), value=float("-inf"))
    for r in range(4):
        piece = padded[:, :, r * rows: (r + 1) * rows + lo + hi]
        got = F.conv2d(piece, w, stride=s, padding=(0, p), groups=3)
        torch.testing.assert_close(got, whole[:, :, r * rows // s: (r + 1) * rows // s], rtol=0, atol=0)
        if rows % 2 == 0:
            got = F.max_pool2d(ninf[:, :, r * rows: (r + 1) * rows + 1], 3, 2, (0, 1))
            torch.testing.assert_close(got, pooled[:, :, r * rows // 2: (r + 1) * rows // 2], rtol=0, atol=0)


@pytest.mark.parametrize("key,mesh", [(k, m) for k in sorted(ADAPTED) for m in LAYOUTS] + [("v2s", "d2s2")])
def test_forward_equals_one_process(runs, key, mesh):
    """A training-mode forward (batch statistics pooled over the ranks) of
    each family: the features and logits (whole on every rank), the
    gradients of a loss of the logits summed over the ranks, and the running
    statistics equal one process's; each BatchNorm of a split level saw the
    rank's slab of the rows, each of a whole level all of them."""
    _, ranks, one = runs[f"{key}_forward"]
    space = MESHES[mesh]["space"]
    for r in ranks:
        got = r[mesh]
        for a, b in zip(got["out"], one["out"]):
            assert _rel(a, b) <= 1e-5
        assert _stats_close(got["stats"], one["stats"]) == len(one["stats"]) > 0
    got = ranks[0][mesh]
    assert got["grad_names"] == one["grad_names"] and len(one["grad_names"]) > 0
    assert _rel(got["grads"], one["grads"]) <= 1e-5
    assert [n for n, _ in got["bn_rows"]] == [n for n, _ in one["bn_rows"]]
    split = [rows * space == whole for (_, rows), (_, whole) in zip(got["bn_rows"], one["bn_rows"])]
    assert all(rows == whole for (_, rows), (_, whole), s in zip(got["bn_rows"], one["bn_rows"], split) if not s)
    # split levels first, then whole ones: the first gathered level stays whole
    assert split[0] and not split[-1] and split == sorted(split, reverse=True)


@pytest.mark.parametrize("name", [f"{k}_{m}" for k in ADAPTED for m in KNOBS])
@pytest.mark.parametrize("mesh", LAYOUTS)
def test_adapters_equal_one_process(runs, name, mesh):
    """Tent, pl, eata, sar, cotta and memo on each family's logits
    (``classifier_logits_apply``), continual and online, on a batch of 16
    with 15 valid rows (the draws the global batch's): each batch's entropies,
    adapted BatchNorm affines, running statistics and CoTTA's teacher equal
    one process's, the predictions exactly; every rank agrees. The affines
    are held elementwise (1e-5 relative plus 2e-6, the space tests' bound):
    a move of 1e-4 on an f32 param near 1 is stored in steps of 1.2e-7, so
    the moves' relative L2 measures f32 storage, not the port."""
    payload, ranks, one = runs[name]
    source = _source(payload)
    r0 = ranks[0][mesh]
    for a, b in zip(r0["ents"], one["ents"]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for got, want in zip(r0["states"], one["states"]):
        for k in _affines(want):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-6, err_msg=k)
        assert _stats_close(got, want) > 0
    for a, b in zip(r0["preds"], one["preds"]):
        np.testing.assert_array_equal(a, b)
    for got, want in zip(r0["teacher"], one["teacher"]):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6)
    assert r0["resets"] == one["resets"] and r0["names"] == one["names"]
    assert any(not np.array_equal(one["state"][k], source[k]) for k in _affines(source))
    for r in ranks[1:]:
        for k, v in r0["state"].items():
            np.testing.assert_array_equal(r[mesh]["state"][k], v, err_msg=k)


@pytest.mark.parametrize("key", ADAPTED)
@pytest.mark.parametrize("mesh", LAYOUTS)
def test_norm_equals_one_process(runs, key, mesh):
    """``norm`` on each family's logits: the running statistics after each
    batch equal one process's and have moved, and so do the adapted
    model's inference-mode logits."""
    payload, ranks, one = runs[f"{key}_norm"]
    source = _source(payload)
    assert all(not np.array_equal(v, source[k]) for k, v in one["states"][0].items())
    for r in ranks:
        for got, want in zip(r[mesh]["states"], one["states"]):
            assert _stats_close(got, want) == len(want) > 0
        assert _rel(r[mesh]["logits"], one["logits"]) <= 1e-5


@pytest.mark.parametrize("key", ADAPTED)
def test_tent_matches_the_reference_on_a_space_mesh(runs, key):
    """Tent's step on each family against the JAX adapter on a
    ``data=1 x space=2`` mesh of the CPU devices, at
    ``tests/test_torch_tta_classification.py``'s bounds: the moves of the
    BatchNorm affines within 1e-3 relative L2 of the reference, or (ResNet
    and DenseNet, computed in f64) of the port's f64 run in one process and
    within 1e-2 of the reference; the running statistics within 3e-5, the entropies within
    1e-3 and the predictions on >= 99% of the images."""
    want, ents, preds = runs.jax[key].result()
    payload, ranks, one = runs[f"{key}_tent"]
    source = _source(payload)
    want = {k: v.numpy() for k, v in want.items()}
    for mesh in LAYOUTS:
        got = ranks[0][mesh]
        rels = [_moves(got["states"][0], want, source), _moves(got["states"][0], one["states"][0], source)]
        assert rels[0] < 1e-3 or ("tent" in WIDE.get(key, ()) and rels[1] < 1e-3 and rels[0] < 1e-2), rels
        assert _stats_close(got["states"][0], want, rel=3e-5) > 0
        np.testing.assert_allclose(got["ents"][0], ents, rtol=1e-3)
        assert (got["preds"][0] == preds).mean() >= 0.99


@pytest.mark.parametrize("kind", ["train", "tent"])
@pytest.mark.parametrize("mesh", sorted(ULP_AXES))
def test_whole_params_stay_equal_over_the_group(runs, kind, mesh):
    """Over ``data=2 x model=2`` (UNETR's heads and MLP cut) and ``data=2 x
    expert=2`` (its MoE block's experts cut), the second rank of a group
    moves every whole gradient by one ulp before the reduction: after it the
    group's ranks hold the same gradients bit for bit, and after each Adam
    step (``SegTrainer``, Tent) the same whole params."""
    _, ranks, _ = runs[f"ulp_{kind}_{mesh}"]
    for lead in (0, 2):  # the groups: ranks (0, 1) and (2, 3)
        a, b = ranks[lead], ranks[lead + 1]
        assert b["bumped"] == (lead == 0) and not a["bumped"]
        if b["bumped"]:
            assert any(not np.array_equal(x, y) for x, y in zip(a["pre"], b["pre"]))
        for x, y in zip(a["post"], b["post"]):
            np.testing.assert_array_equal(x, y)
        for pa, pb in zip(a["params"], b["params"]):
            assert set(pa) == set(pb) and pa
            for k in pa:
                np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
