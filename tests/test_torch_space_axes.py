"""A space axis beside the model, expert and stage axes (``parallel/mesh.py``:
the space group, the data x space group of the sums, ``axis_groups``):
the mesh's groups against the JAX ``make_mesh``'s device layout, then four
gloo ranks on the CPU against the one-process port.

One spawn (``tests/_torch_st_worker.py``, which imports no JAX) builds
three meshes over the four ranks and runs every case on its own, and the
same case functions in one more process without a mesh:

  * UNETR with ``tp_axis="model"`` over ``space=2 x model=2``, with and
    without the sequence axis: each rank holds half the heads and MLP
    features and its depth slab (its block of the tokens); the logits, the
    gradients and two SGD steps equal one process's;
  * the flagship UNet3D with a bottleneck MoE (4 experts, top-2) over
    ``space=2 x expert=2``: each rank holds 2 experts and its slab of the
    bottleneck's tokens; the routing (the dispatch tensor) is one
    process's token for token, and two SGD steps equal one process's;
  * the pipelined ViT over ``space=2 x stage=2``: the space ranks of the
    pipeline are replicas (the reference's ``x_spec = P(None, data)``),
    and its features, logits and gradients equal the sequential model's
    within ``tests/test_pipeline.py``'s tolerances;

then chip_smoke.py's four-rank ``space_axes`` job at fixture size.
Tolerances as ``tests/test_torch_space_transformers.py``'s (1e-5 relative
against one process).
"""

import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.models.vit import ViT as JaxViT
from multimodal_tta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_tta_tpu_torch.models.convert import from_flax
from multimodal_tta_tpu_torch.models.vit import ViT
from multimodal_tta_tpu_torch.parallel import space as sp
from multimodal_tta_tpu_torch.parallel.mesh import AXES, axis_groups
from multimodal_tta_tpu_torch.registry import get_model

from _torch_port import DEVICE_TRANSFORM, SGD, random_flax_params, trainer_config
from _torch_st_worker import spawn

UNETR_KW = dict(in_channels=2, num_classes=1, patch_size=4, hidden_size=32, mlp_dim=64, num_heads=4, num_layers=4,
                feature_size=4, image_size=(32, 16, 16), tp_axis="model")
UNETR_SHAPE = (32, 16, 16, 2)  # 128 tokens: 64 a space rank, its slab of the 8-plane grid
MOE = dict(in_channels=2, num_classes=1, channels=(4, 8, 16), strides=(2, 2), num_res_units=2, moe_experts=4,
           moe_k=2)
MOE_SHAPE = (16, 16, 16, 2)  # a 4-plane bottleneck: 2 a space rank
TINY_VIT = dict(variant="vit_b_16", num_classes=5, image_size=8, patch=4, hidden=32, depth=4, heads=4, mlp_dim=64)
VIT_X = np.random.RandomState(7).randn(8, 8, 8, 3).astype(np.float32)
LABELS = np.array([0, 1, 2, 3, 4, 0, 1, 2])
PHASE = dict(threads=1, unetr=dict(patch_size=4, hidden_size=32, mlp_dim=64, num_heads=4, num_layers=4,
                                   feature_size=4), unetr_shape=(32, 16, 16),
             flagship=dict(channels=[4, 8, 16], strides=[2, 2]), flagship_shape=(16, 16, 16),
             vit=dict(patch=4, hidden=32, depth=4, heads=4, mlp_dim=64, num_classes=5), vit_side=8, vit_batch=8)


def _batches(sizes, seed: int, shape):
    rng = np.random.RandomState(seed)
    return [{"image": (rng.randn(b, *shape) * 100).astype(np.float32),
             "label": (rng.rand(b, *shape[:-1], 1) > 0.7).astype(np.float32)} for b in sizes]


def _state(name: str, kw: dict, seed: int) -> dict:
    return {k: v.clone() for k, v in get_model(name)(**kw, device="cpu", seed=seed).state_dict().items()}


def _cfg(model: dict) -> dict:
    return trainer_config(SGD, model={k: list(v) if isinstance(v, tuple) else v for k, v in model.items()
                                      if k != "image_size"})


def _payloads() -> dict:
    out = {}
    rng = np.random.RandomState(3)
    x, w = (rng.randn(2, *UNETR_SHAPE).astype(np.float32), rng.randn(2, *UNETR_SHAPE[:3], 1).astype(np.float32))
    for tag, seq in (("", None), ("_seq", "space")):
        kw = dict(UNETR_KW, seq_shard_axis=seq)
        state = _state("unetr", kw, 61)
        out[f"unetr{tag}_forward"] = ("forward", "s2m2", dict(name="unetr", model_kw=kw, state=state, x=x, w=w))
        out[f"unetr{tag}_train"] = ("train", "s2m2", dict(
            cfg=_cfg(kw), name="unetr", model_kw=kw, state=state, batches=_batches([2, 2], 62, UNETR_SHAPE),
            device_transform=DEVICE_TRANSFORM))
    state = _state("unet", MOE, 63)
    out["moe_route"] = ("route", "s2e2", dict(name="unet", model_kw=MOE, state=state,
                                              x=_batches([2], 64, MOE_SHAPE)[0]["image"] / 100.0))
    out["moe_train"] = ("train", "s2e2", dict(cfg=_cfg(MOE), name="unet", model_kw=MOE, state=state,
                                              batches=_batches([2, 2], 65, MOE_SHAPE),
                                              device_transform=DEVICE_TRANSFORM))
    out["pipeline_vit"] = ("pipeline_vit", "s2t2", dict(kw=dict(TINY_VIT, in_channels=3), params=VIT_PARAMS, x=VIT_X,
                                                        labels=LABELS, n_micro=4))
    return out


VIT_PARAMS = random_flax_params(JaxViT(**TINY_VIT), (1, 8, 8, 3), 6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every four-rank case in one spawn, then chip_smoke's ``space_axes``
    job at fixture size in the same ranks: ``{name: (payload, [each rank's
    result], the one process's)}`` and ``"phase"``."""
    import chip_smoke

    tmp = str(tmp_path_factory.mktemp("axes"))
    payloads = _payloads()
    prep = chip_smoke.space_axes_prepare("cpu", f"{tmp}/phase", **PHASE)
    ranks, one = spawn(list(payloads.values()), tmp, 400, axes_jobs=[("space_axes", prep["spec"])])
    out = {name: (payloads[name][2], [r[i] for r in ranks], one[i]) for i, name in enumerate(payloads)}
    out["phase"] = chip_smoke.space_axes_compare("cpu", prep)
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _rel_tree(got: dict, want: dict) -> float:
    return _rel(np.concatenate([np.ravel(got[k]) for k in want]), np.concatenate([np.ravel(want[k]) for k in want]))


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [dict(data=1, space=2, model=2), dict(data=1, space=2, expert=2),
                                   dict(data=1, space=2, stage=2), dict(data=2, space=2, model=2),
                                   dict(data=1, space=2, model=2, stage=2), dict(data=2, space=2, expert=2)])
def test_mesh_groups_match_the_reference_layout(sizes):
    """``axis_groups`` (the ranks of each group, from the sizes alone, in
    the reference's axis order with the stage varying fastest) against the
    JAX ``make_mesh``'s device array: the group of an axis is the devices
    that share every other index, and the sums' group (data x space) the
    devices that share the model, expert and stage indices."""
    devices = jax.devices()
    full = {a: sizes.get(a, 1) for a in AXES}
    n = int(np.prod(list(full.values())))
    mesh = jax_make_mesh(devices[:n], **{a: v for a, v in sizes.items() if a != "data"}, data=full["data"])
    ids = np.vectorize(lambda d: devices.index(d))(mesh.devices)
    names = list(mesh.axis_names)

    def reference(axes):
        moved = np.moveaxis(ids, [names.index(a) for a in axes], range(-len(axes), 0))
        return sorted(sorted(int(i) for i in g.ravel()) for g in moved.reshape(-1, int(np.prod(
            [full[a] for a in axes]))))

    for axes in [(a,) for a in names] + [("data", "space")]:
        assert sorted(axis_groups(list(full.values()), *axes)) == reference(axes), axes
    assert sorted(r for g in axis_groups(list(full.values()), "space") for r in g) == list(range(n))


@pytest.mark.parametrize("tag", ["", "_seq"])
def test_unetr_over_space_and_model_equals_one_process(runs, tag):
    """UNETR over ``space=2 x model=2`` (half the heads and MLP features a
    rank, the depth split over the space pair; with the sequence axis each
    rank's block of 64 of the 128 tokens): the gathered logits and the
    summed gradients of ``sum(logits * w)``, then two SGD steps (losses,
    first-step gradients, the whole params) equal one process's; every rank
    of a model pair holds its share of the projections."""
    _, ranks, one = runs[f"unetr{tag}_forward"]
    for r in ranks:
        assert _rel(r["out"][0], one["out"][0]) <= 1e-5
        # a key/value gather a block; the grid's level splits: a block is its slab of the token map
        assert r["token_gathers"] == (UNETR_KW["num_layers"] if tag else 0)
    assert _rel_tree(ranks[0]["grads"], one["grads"]) <= 1e-5
    _, ranks, one = runs[f"unetr{tag}_train"]
    assert ranks[0]["sharded"] and not one["sharded"]
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-5)
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)
    assert _rel_tree(ranks[0]["grads"], one["grads"]) <= 1e-5
    for got, want in zip(ranks[0]["params"], one["params"]):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=2e-6, err_msg=k)


def test_moe_over_space_and_expert_routes_and_trains_as_one_process(runs):
    """The flagship's bottleneck MoE over ``space=2 x expert=2`` (2 of 4
    experts a rank; the bottleneck's 4 planes split, 2 a rank, positions
    from the earlier rank's counts): the dispatch tensor equals one
    process's token for token, and two SGD steps (losses, the whole
    first-step gradients, the params, the aux and dropped share) equal
    one process's."""
    _, ranks, one = runs["moe_route"]
    for r in ranks:
        assert len(r["dispatch"]) == len(one["dispatch"]) == 1
        np.testing.assert_array_equal(r["dispatch"][0], one["dispatch"][0])
        np.testing.assert_allclose(r["aux"], one["aux"], rtol=1e-6)
    _, ranks, one = runs["moe_train"]
    assert any(k.endswith(".wi") for k in ranks[0]["sharded"])
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-5)
    assert _rel_tree(ranks[0]["grads"], one["grads"]) <= 1e-5
    for got, want in zip(ranks[0]["params"], one["params"]):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=2e-6, err_msg=k)
    for got, want in zip(ranks[0]["moe"], one["moe"]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_pipeline_over_space_and_stage_equals_sequential(runs):
    """The pipelined ViT over ``space=2 x stage=2``: the two space ranks of
    a stage pair compute alike (replicas) and their gradients count once;
    the CLS features and logits (``tests/test_pipeline.py:145``'s 2e-5) and
    the cross-entropy's gradients of every param (``:283``'s 5e-4, 5e-5)
    equal the sequential model's on every rank."""
    _, ranks, _ = runs["pipeline_vit"]
    model = ViT(**dict(TINY_VIT, in_channels=3), device="cpu")
    model.load_state_dict(from_flax(VIT_PARAMS), strict=True)
    cls, logits = model(torch.from_numpy(VIT_X))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(LABELS))
    loss.backward()
    for r in ranks:
        np.testing.assert_allclose(r["cls"], cls.detach().numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["logits"], logits.detach().numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=1e-5)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(r["grads"][n], p.grad.numpy(), rtol=5e-4, atol=5e-5, err_msg=n)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])


def test_chip_smoke_space_axes_at_fixture_size(runs):
    """chip_smoke.py's four-rank ``space_axes`` job on the CPU at fixture
    size (UNETR with the sequence axis over ``space=2 x model=2``, the
    flagship's bottleneck MoE over ``space=2 x expert=2``, the pipelined
    ViT over ``space=2 x stage=2``) against its one process, within the
    job's own limits; no kernel launches on the CPU."""
    import chip_smoke

    out = runs["phase"]
    assert set(out["cases"]) == set(chip_smoke.AXES_SPACE_CASES)
    for name, case in out["cases"].items():
        assert case["ok"], (name, case)
    assert all(v == 0 for v in out["launches"].values())


def test_every_refusal_names_an_open_item():
    """Items 12b-v-c, 12b-v-d and 13 (the reference's checkpoint formats)
    are closed: no string of the port names any of them. Every refusal left
    that names a ROADMAP.md item names one that ROADMAP.md lists among its
    open modules (none is left)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    texts = {str(p.relative_to(root)): p.read_text(encoding="utf-8")
             for p in (root / "multimodal_tta_tpu_torch").rglob("*.py")}
    assert not [n for n, t in texts.items() if "12b-v-c" in t or "12b-v-d" in t or "item 13" in t]
    assert not hasattr(sp, "UNPORTED_ITEM") and not hasattr(sp, "require_support")
    roadmap = (root / "ROADMAP.md").read_text(encoding="utf-8")
    queue = roadmap[roadmap.index("### 1. Modules to port"):roadmap.index("### 2.")]
    named = {m for t in texts.values() for m in re.findall(r"ROADMAP\.md, item ([0-9][0-9a-z.-]*)", t)}
    assert all(f"**{item}.**" in queue for item in named), named
