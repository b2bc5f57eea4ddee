"""The sequence axis (``seq_shard_axis="space"``: ``models/vit.py``'s
``SelfAttention`` over a split token axis, ``sequence_axis``,
``parallel/space.py:gather_depth`` on the token dim; UNETR and the ViT classifier): four
gloo ranks on the CPU against the one-process port and the JAX package.

One spawn (``tests/_torch_st_worker.py``, which imports no JAX) runs every
rank case on its mesh, ``data=1 x space=4`` or ``data=2 x space=2``, and
the same case functions in one more process without a mesh:

  * UNETR (``tests/test_models.py:349``'s: patch 4 on [16, 16, 16]) over
    ``space=4``: 64 tokens, 16 a rank; its logits against the JAX model on a
    ``space=4`` mesh of the CPU devices (that test's atol 3e-5), and its
    gradients against one process;
  * UNETR on [32, 16, 16] over ``data=2 x space=2``: 128 tokens, 64 a rank,
    a rank's block its slab of the token grid (8 planes, split); two SGD
    steps, with and without MoE blocks (their routing over the split token
    axis), and a Tent step equal one process's;
  * a ViT classifier at 48 px over ``data=2 x space=2`` (rows split): 10
    tokens, 5 a rank; its CLS features against the JAX model
    (``tests/test_backbones.py:115``'s atol 2e-5), its gradients and a Tent
    step on its logits against one process; at 64 px over ``space=4``, 17
    tokens do not divide and run whole (the reference's no-op);
  * ``SelfAttention`` alone on a split token axis: its output and the
    gradients through the key and value gather against ``jax.grad`` of the
    flax module.

Tolerances: ranks vs one process (f32) within 1e-5 relative (losses,
entropies, the logits' and gradients' relative L2, params within 1e-5
relative plus 2e-6); against the JAX package the tests' own atols.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_tta_tpu.models import vit as jvit
from multimodal_tta_tpu.models.unetr import UNETR as JaxUNETR
from multimodal_tta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_tta_tpu_torch.models.convert import from_flax
from multimodal_tta_tpu_torch.parallel import space as sp

from _torch_port import DEVICE_TRANSFORM, SGD, random_flax_params, trainer_config, tta_config
from _torch_st_worker import spawn

TINY = dict(in_channels=2, num_classes=1, patch_size=4, hidden_size=32, mlp_dim=64, num_heads=4, num_layers=4,
            feature_size=4)  # tests/test_models.py:211
VIT = dict(variant="vit_b_16", num_classes=3, patch=16, hidden=32, depth=2, heads=4, mlp_dim=64)
UNETR_X = np.random.RandomState(3).randn(2, 16, 16, 16, 2).astype(np.float32)
UNETR_W = np.random.RandomState(4).randn(2, 16, 16, 16, 1).astype(np.float32)
VIT48_X = np.random.RandomState(0).randn(2, 48, 48, 3).astype(np.float32)
VIT64_X = np.random.RandomState(5).randn(4, 64, 64, 3).astype(np.float32)
CLS_W = np.random.RandomState(6).randn(4, 3).astype(np.float32)
ATTN_X = np.random.RandomState(7).randn(2, 16, 32).astype(np.float32)
ATTN_W = np.random.RandomState(8).randn(2, 16, 32).astype(np.float32)
SPLIT_GRID = (32, 16, 16, 2)  # 8 x 4 x 4 tokens: 64 a rank, 4 planes of the grid


def _unetr_params(shape, seed):
    return random_flax_params(JaxUNETR(**TINY), (1,) + shape, seed)


def _vit_params(side, seed):
    return random_flax_params(jvit.ViT(**VIT, image_size=side), (1, side, side, 3), seed)


def _attn_params():
    return random_flax_params(jvit.SelfAttention(hidden=32, heads=4), (2, 16, 32), 9)


def _batches(sizes, seed: int, shape, label: bool = True):
    rng = np.random.RandomState(seed)
    out = []
    for b in sizes:
        x = (rng.randn(b, *shape) * 100).astype(np.float32)
        y = (rng.rand(b, *shape[:-1], 1) > 0.7).astype(np.float32)
        out.append({"image": x, "label": y} if label else x)
    return out


def _tent_cfg(**tta):
    cfg = tta_config(**tta)
    cfg["training"]["compute_dtype"] = "float32"
    return cfg


def _payloads() -> dict:
    seq = dict(TINY, seq_shard_axis="space")
    small = from_flax(_unetr_params((16, 16, 16, 2), 11))
    grid = from_flax(_unetr_params(SPLIT_GRID, 12))
    vit48, vit64 = from_flax(_vit_params(48, 13)), from_flax(_vit_params(64, 14))
    unetr16 = dict(name="unetr", model_kw=dict(seq, image_size=(16, 16, 16)), state=small)
    unetr32 = dict(name="unetr", model_kw=dict(seq, image_size=SPLIT_GRID[:3]), state=grid)
    moe_kw = dict(seq, image_size=SPLIT_GRID[:3], moe_experts=2, moe_k=2)
    unetr32moe = dict(name="unetr", model_kw=moe_kw, state=from_flax(random_flax_params(
        JaxUNETR(**dict(TINY, moe_experts=2, moe_k=2)), (1,) + SPLIT_GRID, 18)))
    vit = dict(name="vit_b_16", model_kw=dict(VIT, image_size=48, in_channels=3, seq_shard_axis="space"), state=vit48)
    cls_cfg = _tent_cfg(softmax=True, steps=2, lr=1e-2, episodic=False)
    return {
        "unetr_s4": ("forward", "s4", dict(unetr16, x=UNETR_X, w=UNETR_W)),
        "unetr_grid_train": ("train", "d2s2", dict(
            unetr32, cfg=trainer_config(SGD, model={k: v for k, v in seq.items()}),
            batches=_batches([4, 3], 15, SPLIT_GRID), device_transform=DEVICE_TRANSFORM)),
        "unetr_moe_train": ("train", "d2s2", dict(
            unetr32moe, cfg=trainer_config(SGD, model=dict(seq, moe_experts=2, moe_k=2)),
            batches=_batches([4, 4], 17, SPLIT_GRID), device_transform=DEVICE_TRANSFORM)),
        "unetr_grid_tent": ("tent", "d2s2", dict(
            unetr32, cfg=_tent_cfg(episodic=False, steps=2, lr=1e-2), batches=_batches([4, 4], 16, SPLIT_GRID, False),
            n_valid=[4, 3], mode="inline", device_transform=DEVICE_TRANSFORM)),
        "vit48": ("forward", "d2s2", dict(vit, x=np.concatenate([VIT48_X, VIT48_X[::-1]]), w=CLS_W, classifier=True)),
        "vit48_tent": ("classifier_tent", "d2s2", dict(vit, cfg=cls_cfg, batches=[VIT48_X * 2.0, VIT48_X], n_valid=[2, 1])),
        "vit64_whole": ("forward", "s4", dict(
            name="vit_b_16", model_kw=dict(VIT, image_size=64, in_channels=3, seq_shard_axis="space"), state=vit64,
            x=VIT64_X, w=CLS_W, classifier=True)),
        "attention": ("attention", "s4", dict(hidden=32, heads=4, state=from_flax(_attn_params()), x=ATTN_X, w=ATTN_W)),
    }


def _jax_unetr():
    """The JAX UNETR with the sequence axis on a ``space=4`` mesh (jit, the
    legacy ``with mesh:`` context, as ``tests/test_models.py:349``)."""
    m = JaxUNETR(**TINY, seq_shard_axis="space")
    mesh = jax_make_mesh(jax.devices()[:4], data=1, space=4)
    with mesh:
        return np.asarray(jax.jit(lambda v, x: m.apply(v, x, train=False))(
            {"params": _unetr_params((16, 16, 16, 2), 11)}, jnp.asarray(UNETR_X)))


def _jax_vit():
    """The JAX ViT at 48 px with the sequence axis on a ``data=2 x space=2``
    mesh (``tests/test_backbones.py:115``)."""
    m = jvit.ViT(**VIT, image_size=48, seq_shard_axis="space")
    mesh = jax_make_mesh(jax.devices()[:4], data=2, space=2)
    x = np.concatenate([VIT48_X, VIT48_X[::-1]])
    with mesh:
        feats, logits = jax.jit(lambda v, x: m.apply(v, x, train=False))({"params": _vit_params(48, 13)},
                                                                          jnp.asarray(x))
    return np.asarray(feats), np.asarray(logits)


def _jax_attention():
    """``jax.grad`` of ``sum(SelfAttention(x) * w)`` (flax) into x and the params."""
    m = jvit.SelfAttention(hidden=32, heads=4)
    p = jax.tree_util.tree_map(jnp.asarray, _attn_params())

    def loss(p, x):
        y = m.apply({"params": p}, x)
        return (y * jnp.asarray(ATTN_W)).sum(), y

    (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(ATTN_X))
    return np.asarray(y), np.asarray(gx), {k: v.numpy() for k, v in from_flax(
        jax.tree_util.tree_map(np.asarray, gp)).items()}


class _Runs:
    def __init__(self, tmp: str):
        self.payloads = _payloads()
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.future = self.pool.submit(spawn, list(self.payloads.values()), tmp, 300)
        self.jax_pool = concurrent.futures.ThreadPoolExecutor(3)
        self.jax = {n: self.jax_pool.submit(f) for n, f in (("unetr", _jax_unetr), ("vit", _jax_vit),
                                                             ("attention", _jax_attention))}

    def __getitem__(self, name):
        ranks, one = self.future.result()
        i = list(self.payloads).index(name)
        return self.payloads[name][2], [r[i] for r in ranks], one[i]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(str(tmp_path_factory.mktemp("seq")))
    yield r
    r.pool.shutdown()
    r.jax_pool.shutdown()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _rel_tree(got: dict, want: dict) -> float:
    return _rel(np.concatenate([np.ravel(got[k]) for k in want]), np.concatenate([np.ravel(want[k]) for k in want]))


# ---------------------------------------------------------------------------


def test_the_token_rule():
    """The reference's strict rule: a token axis splits only where its
    count divides by the axis (64 over 4, 128 and 10 over 2), never 17 or
    197 (ViT-B/16 at 224 px) over 4, nor 197 over 2; the blocks a rank's
    depth slab gives are its token block only where the grid's depth
    splits."""
    assert sp.tokens_split(64, 4) and sp.tokens_split(128, 2) and sp.tokens_split(10, 2)
    assert not any(sp.tokens_split(n, s) for n, s in ((17, 4), (197, 4), (197, 2), (64, 1)))

    class Axis:
        size = 4

    # UNETR on [16, 16, 16] at patch 4 over space=4: the 4-plane grid is a plane a rank (whole)
    assert [a is not None for a in sp.level_axes(Axis(), 4, (2, 2))] == [True, True, False]
    Axis.size = 2  # on [32, 16, 16] over space=2: the 8-plane grid splits, 4 planes a rank
    assert [a is not None for a in sp.level_axes(Axis(), 16, (2, 2, 2))][:3] == [True, True, True]


def test_unetr_over_space4_matches_one_process_and_the_reference(runs):
    """UNETR with ``seq_shard_axis="space"`` over ``space=4`` (64 tokens, 16
    a rank; every slab embeds its own patches; the grid's level is whole):
    the gathered logits equal one process's within 1e-5 and the JAX
    model's on a ``space=4`` mesh within ``tests/test_models.py:361``'s
    atol 3e-5; the gradients of ``sum(logits * w)`` summed over the ranks
    equal one process's within 1e-5 relative L2."""
    _, ranks, one = runs["unetr_s4"]
    want = runs.jax["unetr"].result()
    # a key/value gather a block, then the skip's and the top's token maps
    assert [r["token_gathers"] for r in ranks] == [TINY["num_layers"] + 2] * 4 and one["token_gathers"] == 0
    for r in ranks:
        assert _rel(r["out"][0], one["out"][0]) <= 1e-5
        np.testing.assert_allclose(r["out"][0], want, atol=3e-5)
    assert set(ranks[0]["grads"]) == set(one["grads"])
    assert _rel_tree(ranks[0]["grads"], one["grads"]) <= 1e-5


def test_training_with_a_split_token_grid_equals_one_process(runs):
    """Two SGD steps of UNETR with the sequence axis over ``data=2 x
    space=2`` (128 tokens, 64 a rank, each rank's block its slab of the
    8-plane grid, which feeds the decoder as it is; the second batch
    ragged): losses, the first step's summed gradients and the params
    equal one process's; the ranks agree."""
    _, ranks, one = runs["unetr_grid_train"]
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-5)
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)
    assert _rel_tree(ranks[0]["grads"], one["grads"]) <= 1e-5
    for got, want in zip(ranks[0]["params"], one["params"]):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=2e-6, err_msg=k)
    for r in ranks[1:]:
        for k, v in ranks[0]["params"][-1].items():
            np.testing.assert_array_equal(r["params"][-1][k], v, err_msg=k)


def test_moe_blocks_over_a_split_token_axis_equal_one_process(runs):
    """UNETR's MoE blocks (2 experts, top-2) on each rank's block of the
    token axis: a token's buffer position continues the earlier rank's
    counts (``parallel/space.py:space_prefix``), so two SGD steps' losses,
    the sown aux and dropped share, the first step's summed gradients and
    the params equal one process's."""
    _, ranks, one = runs["unetr_moe_train"]
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-5)
    assert len(ranks[0]["moe"]) == len(one["moe"]) == 2
    for got, want in zip(ranks[0]["moe"], one["moe"]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert _rel_tree(ranks[0]["grads"], one["grads"]) <= 1e-5
    for got, want in zip(ranks[0]["params"], one["params"]):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=2e-6, err_msg=k)


def test_tent_with_a_split_token_grid_equals_one_process(runs):
    """Continual inline Tent (2 steps a batch, the second ragged) on the
    same UNETR: entropies, the adapted state and the gathered predictions
    equal one process's."""
    _, ranks, one = runs["unetr_grid_tent"]
    for a, b in zip(ranks[0]["ents"], one["ents"]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for k, v in one["state"].items():
        np.testing.assert_allclose(ranks[0]["state"][k], v, rtol=1e-5, atol=2e-6, err_msg=k)
    for r in ranks[1:]:
        for k, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
    for a, b in zip(ranks[0]["preds"], one["preds"]):
        assert a.shape == b.shape and (a == b).mean() >= 0.9999


def test_vit_at_48px_matches_one_process_and_the_reference(runs):
    """The ViT classifier at 48 px over ``data=2 x space=2``: each rank holds
    its rows of the images (gathered before the patch embed) and 5 of the 10
    tokens; the CLS features and logits come out whole on every rank, equal
    to one process's and to the JAX model's on a ``data=2 x space=2`` mesh
    (``tests/test_backbones.py:138``'s atol 2e-5); the gradients of a loss
    of the logits (``1 / space`` of it on each space rank) summed over the
    ranks equal one process's."""
    _, ranks, one = runs["vit48"]
    feats, logits = runs.jax["vit"].result()
    assert [r["token_gathers"] for r in ranks] == [VIT["depth"] + 1] * 4  # a block's keys and values, the head's
    for r in ranks:
        np.testing.assert_allclose(r["out"][0], one["out"][0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["out"][0], feats, atol=2e-5)
        np.testing.assert_allclose(r["out"][1], logits, atol=2e-5)
    assert _rel_tree(ranks[0]["grads"], one["grads"]) <= 1e-5


def test_vit_tent_equals_one_process(runs):
    """Tent on the ViT's logits (softmax entropy, 2 steps a batch, the
    second batch ragged) over ``data=2 x space=2`` with the sequence axis:
    entropies, the adapted LayerNorms and the predictions equal one
    process's."""
    _, ranks, one = runs["vit48_tent"]
    for r in ranks:
        for a, b in zip(r["ents"], one["ents"]):
            np.testing.assert_allclose(a, b, rtol=1e-5)
        for a, b in zip(r["preds"], one["preds"]):
            np.testing.assert_array_equal(a, b)
        for k, v in one["state"].items():
            np.testing.assert_allclose(r["state"][k], v, rtol=1e-5, atol=2e-6, err_msg=k)
    assert any(not np.array_equal(one["state"][k], v.numpy()) for k, v in runs.payloads["vit48_tent"][2]["state"].items())


def test_an_indivisible_token_count_runs_whole(runs):
    """At 64 px the ViT has 17 tokens, which do not divide over
    ``space=4``: the blocks run whole on every rank (the reference's no-op),
    and the features, logits and gradients equal one process's."""
    _, ranks, one = runs["vit64_whole"]
    assert not sp.tokens_split(17, 4) and all(r["token_gathers"] == 0 for r in ranks)
    for r in ranks:
        for a, b in zip(r["out"], one["out"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert ranks[0]["out"][0].shape == (4, 32)
    assert _rel_tree(ranks[0]["grads"], one["grads"]) <= 1e-5


def test_key_value_gather_matches_jax_grad(runs):
    """``SelfAttention`` on a split token axis over ``space=4`` (16 tokens,
    4 a rank): this rank's queries against the gathered keys and values.
    The gathered output, the gradient into the tokens (each rank's block)
    and the projections' gradients summed over the ranks equal one
    process's and ``jax.grad`` of the flax module."""
    _, ranks, one = runs["attention"]
    y, gx, gp = runs.jax["attention"].result()
    for r in ranks:
        for got, want in ((r["y"], one["y"]), (r["x_grad"], one["x_grad"])):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["y"], y, atol=1e-5)
        np.testing.assert_allclose(r["x_grad"], gx, atol=1e-5)
        for k, v in gp.items():
            np.testing.assert_allclose(r["grads"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(r["grads"][k], one["grads"][k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("model", ["vit", "unetr"])
def test_an_inert_sequence_axis_warns_once(model, caplog):
    """With ``seq_shard_axis="space"`` and no ambient mesh (one process,
    outside every ``space.sharded`` block), ``sequence_axis`` logs the
    reference's warning (``multimodal_tta_tpu/models/vit.py:_maybe_shard_seq``)
    once per axis name: one record over two forwards of the ViT classifier
    or of UNETR, none inside a block whose mesh carries the axis."""
    import torch

    from multimodal_tta_tpu_torch.models import vit as tvit
    from multimodal_tta_tpu_torch.models.unetr import UNETR
    from multimodal_tta_tpu_torch.utils.logger import get_logger

    if model == "vit":
        m = tvit.ViT(**dict(VIT, image_size=48, seq_shard_axis="space"), device="cpu", seed=0)
        x = torch.from_numpy(VIT48_X)
    else:
        m = UNETR(**dict(TINY, seq_shard_axis="space"), image_size=(16, 16, 16), device="cpu", seed=0)
        x = torch.from_numpy(UNETR_X)
    logger = get_logger()
    logger.addHandler(caplog.handler)
    held = set(tvit._seq_shard_warned)
    tvit._seq_shard_warned.clear()
    try:
        with torch.no_grad():
            m(x)
            m(x)
        warned = [r for r in caplog.records if r.levelname == "WARNING"]
        assert [r.getMessage() for r in warned] == [
            "[vit] seq_shard_axis='space' is set but no ambient mesh carries that axis — sequence parallelism "
            "disabled for this trace (run under `with mesh:` / jax.set_mesh)"]

        class _Mesh:  # a one-rank mesh: the reference's always carries data and space
            space, shape = 1, {"data": 1, "space": 1}

        tvit._seq_shard_warned.clear()
        with torch.no_grad(), sp.sharded(_Mesh()):
            m(x)
        assert len([r for r in caplog.records if r.levelname == "WARNING"]) == 1
    finally:
        logger.removeHandler(caplog.handler)
        tvit._seq_shard_warned.clear()
        tvit._seq_shard_warned.update(held)
