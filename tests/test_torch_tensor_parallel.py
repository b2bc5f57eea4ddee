"""The model axis over ranks (``multimodal_tta_tpu_torch/parallel/tensor.py``,
the ``tp_axis`` of ``models/vit.py`` and ``models/unetr.py``): four gloo ranks
on the CPU on a ``data=2 x model=2`` mesh against the one-process port on the
same global batches, and against the JAX models with ``tp_axis="model"`` on
``make_mesh(data=2, model=2)`` of the JAX package's CPU devices. The tiny ViT
and UNETR are ``tests/test_tp.py``'s.

One spawn (``tests/_torch_tp_worker.py``, which imports no JAX) runs every
four-rank case; the one-process runs are the same case functions here.

Tolerances:
  - the forward within 2e-5 of one process and of the reference
    (``tests/test_tp.py``'s own tolerance): the row-parallel products are
    summed over the model group, in another order than one matmul;
  - training (SGD with momentum; a transformer's key bias has a zero
    gradient up to rounding, which Adam scales to a full step) against one
    process: losses within 1e-5 relative, params within
    ``assert_steps_match``'s 1e-5 relative plus 2e-6 absolute; against the
    reference the same with its 2e-5 loss tolerance;
  - Tent: entropies within 1e-5 relative, adapted params within 1e-5
    relative plus 2e-6 absolute of one process; ``assert_adapted_close``'s
    1e-3 relative L2 and predictions on 99.9% of voxels against the
    reference;
  - the shares and the replicated gradients: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core import optim as joptim
from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
from multimodal_tta_tpu.core.trainers.seg_trainer import SegTrainer as JaxSegTrainer
from multimodal_tta_tpu.models.unetr import UNETR as JaxUNETR
from multimodal_tta_tpu.models.vit import ViT as JaxViT
from multimodal_tta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_tta_tpu.parallel.mesh import shard_batch as jax_shard_batch
from multimodal_tta_tpu.tta.tent import TentAdapter as JaxTentAdapter
from multimodal_tta_tpu_torch.core import flax_msgpack, ocdbt, orbax_format
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core.optim import build_optimizer
from multimodal_tta_tpu_torch.models.convert import from_flax
from multimodal_tta_tpu_torch.models.unetr import UNETR
from multimodal_tta_tpu_torch.models.vit import SelfAttention, ViT
from multimodal_tta_tpu_torch.parallel import mesh as pmesh
from multimodal_tta_tpu_torch.parallel.tensor import ShardAxis

from _torch_port import SGD, assert_adapted_close, assert_preds_close, jax_state, random_flax_params
from _torch_port import trainer_config, tta_config
from _torch_tp_worker import CASES, TP_WEIGHTS, spawn

torch.set_num_threads(2)

# tests/test_tp.py:26-44
TINY_VIT = dict(variant="vit_b_16", num_classes=5, image_size=8, patch=4, hidden=32, depth=2, heads=4, mlp_dim=64)
TINY_UNETR = dict(patch_size=4, hidden_size=32, mlp_dim=64, num_heads=4, num_layers=4, feature_size=4)
UNETR_JAX = dict(in_channels=2, num_classes=1, **TINY_UNETR)
UNETR_KW = dict(UNETR_JAX, image_size=(8, 8, 8))
VIT_X = np.random.RandomState(1).randn(4, 8, 8, 3).astype(np.float32)
UNETR_X = np.random.RandomState(2).randn(4, 8, 8, 8, 2).astype(np.float32)
VIT_PARAMS = random_flax_params(JaxViT(**TINY_VIT), (1, 8, 8, 3), 0)
UNETR_PARAMS = random_flax_params(JaxUNETR(**UNETR_JAX), (1, 8, 8, 8, 2), 1)
# SGD with momentum: the attention key bias has a zero gradient up to rounding,
# which Adam would scale up to a full step (``tests/_torch_port.py:ADAM``)
SGD_CFG = trainer_config(SGD)


def _batches(n: int, seed: int):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(4, 8, 8, 8, 2).astype(np.float32),
             "label": (rng.rand(4, 8, 8, 8, 1) > 0.7).astype(np.float32)} for _ in range(n)]


TRAIN = dict(cfg=SGD_CFG, kw=UNETR_KW, params=UNETR_PARAMS, batches=_batches(2, 3))
ACCUM_CFG = trainer_config(dict(SGD, grad_accum=2))
MORE = _batches(1, 4)


def _tent_cfg():
    cfg = tta_config(steps=2, lr=1e-2, predict="post")
    cfg["training"]["compute_dtype"] = "float32"
    return cfg


TENT = dict(cfg=_tent_cfg(), kw=UNETR_KW, params=UNETR_PARAMS,
            batches=[np.random.RandomState(5 + i).randn(4, 8, 8, 8, 2).astype(np.float32) for i in range(2)],
            n_valid=[4, 3])


def _payloads(tmp):
    return {
        "vit": ("forward", dict(kind="vit", kw=dict(TINY_VIT, in_channels=3), params=VIT_PARAMS, x=VIT_X)),
        "unetr": ("forward", dict(kind="unetr", kw=UNETR_KW, params=UNETR_PARAMS, x=UNETR_X)),
        "train": ("train", dict(TRAIN, checkpoint=f"{tmp}/tp", more=MORE)),
        "resume_one": ("train", dict(TRAIN, batches=[], resume=f"{tmp}/one", more=MORE)),
        "zero1": ("train", dict(TRAIN, cfg=trainer_config(dict(SGD, zero1=True)), checkpoint=f"{tmp}/tpz",
                                formats=("orbax", "msgpack"),
                                more=MORE)),
        # 3 steps of grad_accum 2: the checkpoint holds an accumulator mid-way
        "accum": ("train", dict(TRAIN, cfg=ACCUM_CFG, batches=_batches(3, 6), checkpoint=f"{tmp}/tpa", more=MORE)),
        "tent": ("tent", TENT),
        "broadcast": ("broadcast", dict(kw=dict(TINY_VIT, in_channels=3))),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every four-rank case in one spawn: ``{name: (payload, [each rank's
    result])}``; the one-process checkpoint that a case resumes from is
    written first."""
    tmp = str(tmp_path_factory.mktemp("tp"))
    CASES["train"](None, **dict(TRAIN, checkpoint=f"{tmp}/one"))
    payloads = _payloads(tmp)
    ranks = spawn(list(payloads.values()), tmp, world=4, timeout=300)
    return {name: (payload, [r[i] for r in ranks]) for i, (name, (_, payload)) in enumerate(payloads.items())}


def _one(runs, name):
    case, payload = _payloads("")[name][0], runs[name][0]
    return CASES[case](None, **payload)


def _jax_mesh():
    return jax_make_mesh(jax.devices()[:4], data=2, model=2)


# ---------------------------------------------------------------------------
# the mesh


@pytest.mark.parametrize("n,axes", [(8, {"data": 2, "space": 2, "model": 2}), (8, {}), (8, {"model": 4}),
                                    (8, {"data": 2, "space": 2, "model": 3}), (4, {"data": 2, "model": 2}),
                                    (6, {"model": 4})])
def test_mesh_sizes_match_the_reference(n, axes):
    """``tests/test_tp.py:57-80``: a model axis beside the data axis, the
    data size inferred from it, and the reference's message when the ranks
    do not split."""
    try:
        want = jax_make_mesh(jax.devices()[:n], **axes).shape["data"]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmesh.axis_sizes(n, **axes)
        assert str(got.value) == str(e)
        return
    assert pmesh.axis_sizes(n, **axes) == want


def test_mesh_ranks_of_a_model_axis():
    """Rank ``r`` sits at ``(d, m) = divmod(r, model)`` (the reference's axis
    order): its rows are data rank d's, and the shape names the model
    axis."""
    batch = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    for r in range(4):
        m = pmesh.Mesh.__new__(pmesh.Mesh)
        m.data, m.space, m.model, m.rank = 2, 1, 2, r
        d, k = divmod(r, 2)
        assert (m.data_rank, m.model_rank, m.space_rank, m.size, m.sums) == (d, k, 0, 4, True)
        assert m.shape == {"data": 2, "space": 1, "model": 2}
        np.testing.assert_array_equal(m.local(batch), batch[2 * d:2 * d + 2])


# ---------------------------------------------------------------------------
# the forward and the shares


@pytest.mark.parametrize("name", ["vit", "unetr"])
def test_forward_equals_one_process_and_the_reference(runs, name):
    """The ranks' forward of the global batch (each data rank its rows, each
    model rank its heads and MLP features) equals one process's and the JAX
    model's with ``tp_axis="model"`` on a ``data=2 x model=2`` mesh."""
    payload, ranks = runs[name]
    one = _one(runs, name)
    jm = JaxViT(**TINY_VIT, tp_axis="model") if name == "vit" else JaxUNETR(**UNETR_JAX, tp_axis="model")
    with _jax_mesh():
        ref = jax.device_get(jax.jit(jm.apply)({"params": payload["params"]}, jnp.asarray(payload["x"])))
    ref = ref if isinstance(ref, tuple) else (ref,)
    for r in ranks:
        for got, want, jwant in zip(r["out"], one["out"], ref):
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(got, np.asarray(jwant), rtol=2e-5, atol=2e-5)
    for a, b in zip(ranks[0]["out"], ranks[1]["out"]):
        np.testing.assert_array_equal(a, b)


def test_rank_zero_weights_reach_every_rank_before_the_cut(runs):
    """Each rank builds its whole model from a seed of its own (the rank);
    the broadcast that precedes the cut gives every rank, of every model
    group, rank 0's whole model, so the shares reassemble to one process's
    model of seed 0."""
    _, ranks = runs["broadcast"]
    one = _one(runs, "broadcast")["whole"]
    other = ViT(**TINY_VIT, in_channels=3, tp_axis="model", device="cpu", seed=1).state_dict()
    assert any(not np.array_equal(other[k].numpy(), v) for k, v in one.items())  # the seeds differ
    for r in ranks:
        assert set(r["whole"]) == set(one)
        for k, v in one.items():
            np.testing.assert_array_equal(r["whole"][k], v)


@pytest.mark.parametrize("name", ["vit", "unetr"])
def test_each_rank_holds_half_the_projections(runs, name):
    """Each rank holds half the bytes of attention and MLP weights one
    process holds (the out projection's and ``Dense_1``'s biases, added once
    after the sum, stay whole), and the ranks of a model group hold other
    halves of each cut tensor."""
    _, ranks = runs[name]
    one = _one(runs, name)
    whole_bias = sum(np.asarray(v).nbytes for k, v in one["whole"].items()
                     if k.endswith(("out.bias", "Dense_1.bias")))
    for r in ranks:
        assert r["tp_bytes"] - whole_bias == (one["tp_bytes"] - whole_bias) // 2
        for n in r["sharded"]:
            assert np.prod(r["shapes"][n]) * 2 == np.prod(one["shapes"][n])
    assert all(any(k in n for k in TP_WEIGHTS) for n in ranks[0]["sharded"])
    assert len(ranks[0]["sharded"]) == (2 if name == "vit" else 4) * 10


@pytest.mark.parametrize("name", ["vit", "unetr"])
def test_converter_shares_reassemble_the_whole_tree(runs, name):
    """``from_flax(params, model)`` cuts each rank's share of the reference's
    params; the shares gathered over the model group are the one-process
    tree bit for bit."""
    payload, ranks = runs[name]
    want = from_flax(payload["params"])
    for r in ranks:
        assert set(r["whole"]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(r["whole"][k], v.numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# training


def test_training_steps_equal_one_process(runs):
    """Two SGD steps of UNETR at global batch 4 over ``data=2 x model=2``
    equal one process's; the replicated params' gradients are the same on
    every rank, with no all-reduce over the model group to make them so."""
    _, ranks = runs["train"]
    one = _one(runs, "train")
    source = from_flax(UNETR_PARAMS)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
        for i, (got, want) in enumerate(zip(r["params"], one["params"])):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-6, err_msg=f"{k} {i}")
                if i == 0 and k.endswith(".weight") and "Dense_0" in k:
                    assert not np.array_equal(got[k], source[k].numpy())
    grads = [r["replicated_grads"] for r in ranks]
    assert grads[0] and set(grads[0]) == set(grads[1])
    for k in grads[0]:
        for g in grads[1:]:
            np.testing.assert_array_equal(grads[0][k], g[k], err_msg=k)


def test_training_steps_match_the_reference(runs):
    """The four-rank steps against the JAX SegTrainer on UNETR with
    ``tp_axis="model"`` on a ``data=2 x model=2`` mesh."""
    payload, ranks = runs["train"]
    jcfg = JaxConfigNode(payload["cfg"])
    mesh = _jax_mesh()
    jparams = jax.tree_util.tree_map(jnp.asarray, UNETR_PARAMS)
    tx, lr = joptim.build_optimizer(jcfg.training, jparams)
    with mesh:
        jt = JaxSegTrainer(jcfg, mesh=mesh)
        jt.setup(JaxTrainState.create(apply_fn=JaxUNETR(**UNETR_JAX, tp_axis="model").apply, params=jparams,
                                      tx=tx), None, joptim.EpochScheduler(jcfg.training, lr))
        for i, batch in enumerate(payload["batches"]):
            jt.run_step(batch)
            np.testing.assert_allclose(ranks[0]["loss"][i], jt.flush_step_metrics()["loss"], rtol=2e-5)
            ref = from_flax(jax.tree_util.tree_map(np.asarray, jt.state.params))
            for n, p in ranks[0]["params"][i].items():
                np.testing.assert_allclose(p, ref[n].numpy(), rtol=1e-5, atol=2e-6,
                                           err_msg=f"{n} after step {i}")


def test_checkpoint_moves_between_the_model_axis_and_one_process(runs):
    """Rank 0 writes the whole tree of a ``model=2`` run (params and
    momentum buffers gathered); one process resumes it and takes the next step as the
    ranks did. A one-process checkpoint resumes over the four ranks the
    same way."""
    payload, ranks = runs["train"]
    resumed = CASES["train"](None, **dict(payload, batches=[], checkpoint=None, resume=payload["checkpoint"]))
    np.testing.assert_allclose(resumed["loss"], ranks[0]["loss"][2:], rtol=1e-5)
    for k, v in resumed["params"][0].items():
        np.testing.assert_allclose(v, ranks[0]["params"][2][k], rtol=1e-5, atol=2e-6, err_msg=k)
    raw = flax_msgpack.load(payload["checkpoint"] + ".msgpack")  # the reference's format, whole
    assert raw["params"]["block0"]["Dense_0"]["kernel"].shape == (32, 64)
    back = runs["resume_one"][1]
    one = _one(runs, "resume_one")
    for r in back:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
        for k, v in one["params"][0].items():
            np.testing.assert_allclose(r["params"][0][k], v, rtol=1e-5, atol=2e-6, err_msg=k)


def test_grad_accum_checkpoint_moves_between_the_model_axis_and_one_process(runs):
    """``grad_accum`` over ``model=2``: rank 0 writes the whole tree with the
    accumulator of a half-done step gathered, and one process resumes it:
    the next steps as the ranks took them."""
    payload, ranks = runs["accum"]
    resumed = CASES["train"](None, **dict(payload, batches=[], checkpoint=None, resume=payload["checkpoint"]))
    np.testing.assert_allclose(resumed["loss"], ranks[0]["loss"][3:], rtol=1e-5)
    for k, v in resumed["params"][0].items():
        np.testing.assert_allclose(v, ranks[0]["params"][3][k], rtol=1e-5, atol=2e-6, err_msg=k)
    raw = flax_msgpack.load(payload["checkpoint"] + ".msgpack")
    acc = raw["opt_state"]["acc_grads"]["block0"]["Dense_0"]["kernel"]
    assert int(raw["opt_state"]["mini_step"]) == 1 and acc.shape == (32, 64) and bool(acc.any())


def test_zero1_over_the_data_group_of_each_model_rank(runs):
    """ZeRO-1 partitions the momentum over the data group of each model rank:
    the same losses and params bit for bit as without it, and its checkpoint
    (consolidated per data group, the moments gathered over the model
    group) resumes in one process as the plain run's does. Its orbax file
    (ZeRO-1 beside a model axis: gathered, rank 0 writes it all) holds the
    msgpack file's leaves bitwise."""
    payload, ranks = runs["zero1"]

    def leaves(payload) -> dict:
        return {".".join(k for k, _ in keys): v for keys, v in orbax_format.flatten(payload)}

    got, want = (leaves(load(payload["checkpoint"] + ext)) for load, ext in (
        (orbax_format.load, ".orbax"), (flax_msgpack.load, ".msgpack")))
    assert got.keys() == want.keys() and all(
        got[k] == v if isinstance(v, str) else torch.equal(torch.as_tensor(got[k]), torch.as_tensor(v))
        for k, v in want.items())
    for r in (1, 2, 3):
        with ocdbt.Database(f"{payload['checkpoint']}.orbax/ocdbt.process_{r}") as db:
            assert not list(db.entries())
    plain = runs["train"][1]
    for r, p in zip(ranks, plain):
        assert r["loss"] == p["loss"]
        for a, b in zip(r["params"], p["params"]):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    resumed = CASES["train"](None, **dict(payload, cfg=SGD_CFG, batches=[], checkpoint=None,
                                          resume=payload["checkpoint"]))
    np.testing.assert_allclose(resumed["loss"], ranks[0]["loss"][2:], rtol=1e-5)
    for k, v in resumed["params"][0].items():
        np.testing.assert_allclose(v, ranks[0]["params"][2][k], rtol=1e-5, atol=2e-6, err_msg=k)


# ---------------------------------------------------------------------------
# Tent


def test_tent_over_the_model_axis_equals_one_process(runs):
    """Tent (two steps, strict, a ragged second batch) on UNETR over
    ``data=2 x model=2`` adapts the replicated LayerNorm and InstanceNorm
    affines as one process does, the same on every rank."""
    _, ranks = runs["tent"]
    one = _one(runs, "tent")
    assert ranks[0]["adapted"] == one["adapted"] and any("LayerNorm" in n for n in one["adapted"])
    for r in ranks:
        for a, b in zip(r["ents"], one["ents"]):
            np.testing.assert_allclose(a, b, rtol=1e-5)
        for k, v in one["state"].items():
            np.testing.assert_allclose(r["state"][k], v, rtol=1e-5, atol=2e-6, err_msg=k)
        for a, b in zip(r["preds"], one["preds"]):
            assert (a == b).mean() >= 0.9999
    for k in ranks[0]["adapted"]:
        np.testing.assert_array_equal(ranks[0]["state"][k], ranks[1]["state"][k])


def test_tent_over_the_model_axis_matches_the_reference(runs):
    """The four-rank adapter against the JAX TentAdapter on UNETR with
    ``tp_axis="model"`` on a ``data=2 x model=2`` mesh
    (``tests/test_tp.py:140``)."""
    payload, ranks = runs["tent"]
    cfg = JaxConfigNode(payload["cfg"])
    mesh = _jax_mesh()
    state = jax_state(UNETR_PARAMS, module=JaxUNETR(**UNETR_JAX, tp_axis="model"))
    with mesh:
        adapter = JaxTentAdapter(cfg.tta, config=cfg, mesh=mesh)
        fn = adapter.make_adapt_predict_fn(state, threshold=0.3, predict_mode="post")
        cur, ents, preds = state, [], []
        for x, n in zip(payload["batches"], payload["n_valid"]):
            cur, pred = fn(cur, jax_shard_batch({"image": x}, mesh)["image"], n)
            ents.append(np.asarray(adapter._last_ents))
            preds.append(np.asarray(pred))
    adapted = from_flax(jax.tree_util.tree_map(np.asarray, cur.params))
    assert_adapted_close({k: torch.from_numpy(v) for k, v in ranks[0]["state"].items()}, adapted,
                         from_flax(UNETR_PARAMS), ranks[0]["adapted"])
    for a, b in zip(ranks[0]["ents"], ents):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert_preds_close(ranks[0]["preds"], preds)


# ---------------------------------------------------------------------------
# what the model axis refuses


def test_what_the_model_axis_refuses():
    """The sequence axis builds and, without a space axis, computes what the
    model without it computes, and a space axis beside a model axis pairs
    the ranks of one model index (over ranks:
    ``tests/test_torch_space_axes.py``); a ``tp_axis`` other than ``model``
    and a head count that does not split raise ``ValueError``; Adafactor
    builds over a model axis (its steps against one process:
    ``tests/test_torch_expert_parallel.py``)."""
    for cls, kw, x in ((UNETR, UNETR_KW, UNETR_X), (ViT, TINY_VIT, VIT_X)):
        seq = cls(**kw, seq_shard_axis="space", tp_axis="model", device="cpu", seed=3)
        plain = cls(**kw, tp_axis="model", device="cpu", seed=3)
        with torch.no_grad():
            for a, b in zip(*(m(torch.from_numpy(x)) if cls is ViT else (m(torch.from_numpy(x)),)
                              for m in (seq, plain))):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert pmesh.axis_groups([1, 2, 2, 1, 1], "space") == [[0, 2], [1, 3]]
    assert pmesh.axis_groups([1, 2, 2, 1, 1], "data", "space") == [[0, 2], [1, 3]]
    with pytest.raises(ValueError, match="shard over the 'model' axis"):
        SelfAttention(32, 4, tp_axis="data")
    with pytest.raises(ValueError, match="heads=4 does not split over a model axis of 3"):
        SelfAttention(32, 4, tp_axis="model").shard(ShardAxis(3, 0))
    model = UNETR(**UNETR_KW, tp_axis="model", device="cpu")
    model.block0.shard(ShardAxis(2, 1))
    model.block0.MultiHeadDotProductAttention_0.shard(ShardAxis(2, 1))
    cfg = ConfigNode(trainer_config({"optimizer": "adafactor", "optimizers": {"adafactor": {"lr": 1e-2}}}))
    tx, _ = build_optimizer(cfg.training, model)
    q = model.block0.MultiHeadDotProductAttention_0.query.weight  # [heads * hd / 2, H]: flax [H, heads, hd]
    assert tx.cuts[id(q)][:2] == (0, 1) and tx.cuts[id(model.block0.Dense_1.weight)][:2] == (1, 0)
    # one process runs a tp_axis model whole: no module is cut without a model axis
    assert not any(getattr(m, "tp", None) for m in UNETR(**UNETR_KW, tp_axis="model", device="cpu").modules())


def test_chip_smoke_model_axis_phase_at_fixture_size(tmp_path):
    """chip_smoke.py's phase 25 on the CPU at fixture size (UNETR hidden 64,
    4 layers, on [32,32,32]): four spawned gloo ranks on ``data=2 x
    model=2`` against one process within the phase's limits; each rank holds
    half the projections and all-reduces over the model group twice a block
    forward and twice backward, and once a step the whole params' gradients
    (their average: the ranks' params stay bit for bit equal)."""
    import chip_smoke

    out = chip_smoke.model_axis_phase("cpu", str(tmp_path / "tp"), shape=(32, 32, 32), threads=1,
                                      model=dict(hidden_size=64, mlp_dim=128, num_heads=4, num_layers=4,
                                                 feature_size=4))
    assert out["logit_max_abs"] <= chip_smoke.TP_LOGIT_REL * out["logit_scale"]
    assert out["losses"]["max_rel"] <= chip_smoke.DP_LOSS_REL and out["delta_rel_l2"] <= chip_smoke.DP_DELTA_REL
    assert set(out["tent"]) == {"inline", "post"}
    assert out["launches"] == {"forward": 0, "backward": 0}
    for r in out["ranks"]:
        assert r["sharded"] == 4 * 10
        # [2 rows, 8 tokens, 64] f32 per call: 4 blocks x (2 forward + 2 backward),
        # then the step's average of the whole params' gradients and the loss
        assert r["whole_grad_bytes"] > 4
        assert r["step_reduced"]["model"] == 4 * 4 * 2 * 8 * 64 * 4 + r["whole_grad_bytes"]
