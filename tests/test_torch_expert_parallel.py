"""The expert axis over ranks (``parallel/expert.py``, ``models/moe.py`` over
``expert_axis``) and Adafactor over a cut axis (``core/optim.py``): four gloo
ranks on the CPU on a ``data=2 x expert=2`` mesh (and on ``data=2 x
model=2`` for Adafactor over the model axis) against the one-process port on
the same global batches, and against the JAX package on ``make_mesh`` of its
CPU devices with the reference tests' cases (``tests/test_moe.py:133``,
``:144``, ``:189``; ``tests/test_zero1.py:129``).

One spawn (``tests/_torch_ep_worker.py``, which imports no JAX) runs every
four-rank case; the one-process runs are the same case functions here.

Tolerances:
  - the ``data x expert`` forward within 1e-5 of the reference
    (``tests/test_moe.py``'s own) and of one process: a rank sums its
    experts' share of the combine over the expert group, in another order
    than one einsum;
  - the router's and the input's gradients (``model.moe_aux_weight > 0``)
    within 1e-6 of the largest value of one process's;
  - training (SGD with momentum: a transformer's key bias has a zero
    gradient up to rounding, which Adam scales to a full step) and Adafactor
    against one process: losses within 1e-5 relative, params within 1e-5
    relative plus 2e-6 absolute; against the reference on its ``data=2 x
    expert=2`` mesh losses within 2e-5 and params within 1e-5 relative plus
    5e-6 absolute (that run's partitioned sums put its own second-step
    params 2.2e-6 beyond 1e-5 relative from its single-device run);
  - Tent: entropies within 1e-5 relative, adapted params within 1e-5
    relative plus 2e-6 absolute, predictions on 99.99% of voxels;
  - the shares, the gradients of whole params across an expert group and
    ZeRO-1 against plain steps: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core import optim as joptim
from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
from multimodal_tta_tpu.core.trainers.seg_trainer import SegTrainer as JaxSegTrainer
from multimodal_tta_tpu.models.moe import MoEMlp as JaxMoE
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu.models.unetr import UNETR as JaxUNETR
from multimodal_tta_tpu.parallel.mesh import expert_state_sharding, train_state_sharding
from multimodal_tta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_tta_tpu_torch.core import flax_msgpack
from multimodal_tta_tpu_torch.parallel import mesh as pmesh

from _torch_port import SGD, random_flax_params, trainer_config, tta_config
from _torch_ep_worker import CASES, spawn

torch.set_num_threads(2)

# tests/test_moe.py:133: MoEMlp(hidden=8, mlp_dim=16, num_experts=4, k=2, capacity_factor=2.0) on [4, 12, 8]
MOE = {k: dict(hidden=8, mlp_dim=16, num_experts=4, k=k, capacity_factor=2.0 if k == 2 else 1.25) for k in (1, 2)}
MOE_X = np.random.RandomState(0).randn(4, 12, 8).astype(np.float32)
MOE_G = np.random.RandomState(1).randn(4, 12, 8).astype(np.float32)
MOE_PARAMS = {k: random_flax_params(JaxMoE(**MOE[k]), (4, 12, 8), 10 + k) for k in (1, 2)}
AUX_WEIGHT = 0.5  # large enough that the load balance's gradient would show if it entered twice
# tests/test_moe.py:189: the MoE UNETR of the reference's expert tests, 4 experts
UNETR_JAX = dict(in_channels=2, num_classes=1, patch_size=4, hidden_size=16, mlp_dim=32, num_heads=2, num_layers=4,
                 feature_size=4, moe_experts=4, moe_every=2)
UNETR_KW = dict(UNETR_JAX, image_size=(16, 16, 16))
UNETR_PARAMS = random_flax_params(JaxUNETR(**UNETR_JAX), (1, 16, 16, 16, 2), 3)
MODEL = {"moe_experts": 4, "moe_aux_weight": 0.01}
SGD_CFG = trainer_config(SGD, model=MODEL)
ADAM_CFG = trainer_config({"optimizer": "adam", "optimizers": {"adam": {"lr": 1e-3, "weight_decay": 0.0}}},
                          model=MODEL)
# the flagship's bottleneck MoE (tests/test_moe.py:test_conv_flagship_moe_bottleneck) under Adafactor
UNET_JAX = dict(in_channels=2, num_classes=1, channels=(4, 8, 16), strides=(2, 2), num_res_units=1, moe_experts=4)
UNET_PARAMS = random_flax_params(JaxUNet3D(**UNET_JAX), (1, 8, 8, 8, 2), 4)
ADAFACTOR = {"optimizer": "adafactor", "optimizers": {"adafactor": {
    "lr": 1e-2, "min_dim_size_to_factor": 4, "momentum": 0.9, "multiply_by_parameter_scale": True}}}
# the model axis: tests/test_tp.py's tiny UNETR; the attention key bias is frozen in both runs (its gradient
# is rounding, which Adafactor scales to a full step)
TP_JAX = dict(in_channels=2, num_classes=1, patch_size=4, hidden_size=32, mlp_dim=64, num_heads=4, num_layers=2,
              feature_size=4)
TP_KW = dict(TP_JAX, image_size=(8, 8, 8), tp_axis="model")
TP_PARAMS = random_flax_params(JaxUNETR(**TP_JAX), (1, 8, 8, 8, 2), 5)
KEY_BIAS = ("key.bias",)
PHASE26 = dict(shape=(32, 32, 32), threads=1, model=dict(hidden_size=32, mlp_dim=64, num_heads=4, num_layers=4,
                                                         feature_size=4, moe_experts=4),
               adafactor=dict(min_dim_size_to_factor=32))  # so that the narrow experts' wi and wo factor


def _batches(n: int, seed: int, shape=(16, 16, 16)):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(4, *shape, 2).astype(np.float32),
             "label": (rng.rand(4, *shape, 1) > 0.7).astype(np.float32)} for _ in range(n)]


TRAIN = dict(kind="unetr", cfg=SGD_CFG, kw=UNETR_KW, params=UNETR_PARAMS, batches=_batches(2, 6))
MORE = _batches(1, 7)
# Adafactor's cut statistics: a row statistic along the cut (w_d0), a column one (w_d1), per-expert
# statistics (experts), a cut of an unfactored tensor (vec); each cut in half over the expert group
CUT_SHAPES = {"w_d0": (6, 8), "w_d1": (8, 6), "experts": (4, 6, 5), "vec": (6,)}
CUT_DIMS = {"w_d0": 1, "w_d1": 1, "experts": 0, "vec": 0}
CUT_GRADS = [{n: np.random.RandomState(20 + i).randn(*s).astype(np.float32) for n, s in CUT_SHAPES.items()}
             for i in range(3)]
CUT_KW = dict(lr=0.1, min_dim_size_to_factor=4, momentum=0.9, multiply_by_parameter_scale=True)


def _tent_cfg(predict: str):
    cfg = tta_config(steps=2, lr=1e-2, predict=predict, episodic=predict == "post")
    cfg["training"]["compute_dtype"] = "float32"
    cfg["model"] = MODEL
    return cfg


TENT_X = [np.random.RandomState(8 + i).randn(4, 16, 16, 16, 2).astype(np.float32) for i in range(2)]
TENT = {mode: dict(cfg=_tent_cfg(mode), kw=UNETR_KW, params=UNETR_PARAMS, batches=TENT_X, n_valid=[4, 3],
                   mode=mode) for mode in ("inline", "post")}
SURFACE = {"region_order": ["GTV"], "threshold": 0.3, "spacing": [1.0, 1.0, 1.0]}
EVAL = dict(cfg=dict(_tent_cfg("post"), evaluation={"seg": SURFACE}), kw=UNETR_KW, params=UNETR_PARAMS,
            batches=_batches(2, 9))


def _payloads(tmp):
    return {
        "moe1": ("moe", "expert", dict(kw=MOE[1], params=MOE_PARAMS[1], x=MOE_X, g=MOE_G, aux_weight=AUX_WEIGHT)),
        "moe2": ("moe", "expert", dict(kw=MOE[2], params=MOE_PARAMS[2], x=MOE_X, g=MOE_G, aux_weight=AUX_WEIGHT)),
        "train": ("train", "expert", dict(TRAIN, checkpoint=f"{tmp}/ep", more=MORE)),
        "adam": ("train", "expert", dict(TRAIN, cfg=ADAM_CFG, batches=_batches(1, 10) * 3)),
        "resume_one": ("train", "expert", dict(TRAIN, batches=[], resume=f"{tmp}/one", more=MORE)),
        "zero1": ("train", "expert", dict(TRAIN, cfg=trainer_config(dict(SGD, zero1=True), model=MODEL),
                                          checkpoint=f"{tmp}/epz", more=MORE)),
        "adafactor_expert": ("train", "expert", dict(kind="unet", cfg=trainer_config(ADAFACTOR, model=MODEL),
                                                     kw=UNET_JAX, params=UNET_PARAMS,
                                                     batches=_batches(2, 11, (8, 8, 8)))),
        "adafactor_model": ("train", "model", dict(kind="unetr", cfg=trainer_config(ADAFACTOR), kw=TP_KW,
                                                   params=TP_PARAMS, batches=_batches(2, 12, (8, 8, 8)),
                                                   frozen=KEY_BIAS)),
        "adafactor_cuts": ("adafactor_cuts", "expert", dict(shapes=CUT_SHAPES, dims=CUT_DIMS, grads=CUT_GRADS,
                                                            kw=CUT_KW)),
        "tent_inline": ("tent", "expert", TENT["inline"]),
        "tent_post": ("tent", "expert", TENT["post"]),
        "evaluate": ("evaluate", "expert", EVAL),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every four-rank case in one spawn: ``{name: (payload, [each rank's
    result])}``; the one-process checkpoint that a case resumes from is
    written first."""
    import chip_smoke

    tmp = str(tmp_path_factory.mktemp("ep"))
    CASES["train"](None, **dict(TRAIN, checkpoint=f"{tmp}/one"))
    payloads = _payloads(tmp)
    phase = chip_smoke.expert_axis_prepare("cpu", f"{tmp}/phase26", **PHASE26)
    ranks = spawn(list(payloads.values()), tmp, world=4, timeout=300, axes_jobs=[("expert_axis", phase["spec"])])
    out = {name: (payload, [r[i] for r in ranks]) for i, (name, (_, _, payload)) in enumerate(payloads.items())}
    out["phase26"] = (phase, None)
    return out


def _one(runs, name):
    """The one-process run of a case (writing no checkpoint over the ranks')."""
    case, _, _ = _payloads("")[name]
    payload = runs[name][0]
    return CASES[case](None, **(dict(payload, checkpoint=None) if "checkpoint" in payload else payload))


def _jax_mesh():
    return jax_make_mesh(jax.devices()[:4], data=2, expert=2)


def _close_to_largest(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert float(np.abs(got - want).max()) <= rel * float(np.abs(want).max())


def _steps_close(ranks, one, loss_rtol=1e-5):
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=loss_rtol)
        for i, (got, want) in enumerate(zip(r["params"], one["params"])):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-6, err_msg=f"{k} after step {i}")


# ---------------------------------------------------------------------------
# the mesh


@pytest.mark.parametrize("n,axes", [(8, {"data": 2, "expert": 4}), (8, {"data": 2, "stage": 4}), (4, {"expert": 2}),
                                    (8, {"data": 1, "space": 2, "model": 2, "stage": 2}), (6, {"expert": 4}),
                                    (8, {"model": 2, "expert": 2, "stage": 2})])
def test_mesh_sizes_match_the_reference(n, axes):
    """``tests/test_pipeline.py:33-45``, ``tests/test_moe.py:133``: the
    expert and stage axes beside the data axis, the data size inferred from
    them, and the reference's message when the ranks do not split."""
    try:
        want = jax_make_mesh(jax.devices()[:n], **axes)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmesh.axis_sizes(n, **axes)
        assert str(got.value) == str(e)
        return
    assert pmesh.axis_sizes(n, **axes) == want.shape["data"]
    m = pmesh.Mesh.__new__(pmesh.Mesh)
    m.rank, m.data = 0, want.shape["data"]
    for a in ("space", "model", "expert", "stage"):
        setattr(m, a, axes.get(a, 1))
    assert tuple(m.shape) == want.axis_names and m.shape == dict(want.shape)


def test_mesh_ranks_in_the_reference_order():
    """Rank ``r`` of ``model x expert x stage`` sits where the reference's
    reshape of the device list puts device ``r`` (stage fastest); it holds
    every row, ``global_rank`` inverts the indices, and only a rank of
    model, expert and stage index 0 writes."""
    sizes = {"data": 1, "model": 2, "expert": 2, "stage": 2}
    jm = jax_make_mesh(jax.devices()[:8], **sizes)
    where = {int(d.id): idx for idx, d in np.ndenumerate(jm.devices)}
    batch = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    for r in range(8):
        m = pmesh.Mesh.__new__(pmesh.Mesh)
        m.space, m.rank = 1, r
        for a, n in sizes.items():
            setattr(m, a, n)
        d, _, mo, e, s = where[jax.devices()[r].id]
        assert (m.data_rank, m.model_rank, m.expert_rank, m.stage_rank) == (d, mo, e, s)
        assert m.global_rank() == r and m.global_rank(stage=1 - s) == r + (1 - 2 * s)
        assert m.replica_lead == (mo == e == s == 0)
        np.testing.assert_array_equal(m.local(batch), batch)


# ---------------------------------------------------------------------------
# MoEMlp over the expert axis


def test_moe_forward_matches_the_reference(runs):
    """``tests/test_moe.py:133``: the ``data x expert`` forward of top-2
    routing at capacity factor 2 equals one process's and the JAX module's
    on a ``data=2 x expert=2`` mesh within 1e-5; each rank holds 2 of the 4
    experts and the whole router."""
    payload, ranks = runs["moe2"]
    one = _one(runs, "moe2")
    m = JaxMoE(**MOE[2])
    with _jax_mesh():
        ref = np.asarray(jax.jit(m.apply)({"params": payload["params"]}, jnp.asarray(payload["x"])))
    for r in ranks:
        np.testing.assert_allclose(r["y"], ref, atol=1e-5)
        np.testing.assert_allclose(r["y"], one["y"], atol=1e-5)
        assert r["shapes"]["wi"] == (2, 8, 16) and r["shapes"]["bo"] == (2, 8)
        assert r["shapes"]["router.weight"] == one["shapes"]["router.weight"] == (4, 8)


@pytest.mark.parametrize("name", ["moe1", "moe2"])
def test_router_and_input_gradients_equal_one_process(runs, name):
    """With the load balance in the loss (``moe_aux_weight`` 0.5), the
    router's gradient (summed over the data group) and the input's equal one
    process's within 1e-6 of their largest value: each rank's expert path
    is summed over the expert group (the gates and the tokens enter it
    through ``copy_to``), and the aux term's gradient enters once. Before
    any sum over the data group the router's gradient is the same on the
    two ranks of an expert group, bit for bit; the experts' gradients,
    gathered whole, equal one process's."""
    _, ranks = runs[name]
    one = _one(runs, name)
    for r in ranks:
        _close_to_largest(r["x_grad"], one["x_grad"], 1e-6)
        for got, want in zip(r["router_grad_summed"], one["router_grad"]):
            _close_to_largest(got, want, 1e-6)
        for k, want in one["expert_grads"].items():
            _close_to_largest(r["expert_grads"][k], want, 1e-6)
        assert abs(r["aux"] - one["aux"]) <= 1e-6
    for d in (0, 2):  # rank (d, 0) against (d, 1)
        for a, b in zip(ranks[d]["router_grad"], ranks[d + 1]["router_grad"]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# training


def test_each_rank_holds_its_experts_and_their_moments(runs):
    """``tests/test_moe.py:144``: the leaves the reference's
    ``expert_state_sharding`` puts on the expert axis (``wi``, ``bi``,
    ``wo``, ``bo`` of each MoE block, and their Adam moments) hold 2 of the
    4 experts on each rank; the router and every other leaf are whole."""
    _, ranks = runs["adam"]
    one = _one(runs, "adam")
    mesh = jax_make_mesh(jax.devices()[:4], data=2, expert=2)
    params = jax.tree_util.tree_map(jnp.asarray, UNETR_PARAMS)
    state = JaxTrainState.create(apply_fn=JaxUNETR(**UNETR_JAX).apply, params=params, tx=optax.adam(1e-3))
    specs = expert_state_sharding(mesh, state).params
    cut = {f"{'.'.join(str(k.key) for k in path[:-1])}.{path[-1].key}"
           for path, s in jax.tree_util.tree_flatten_with_path(specs)[0] if "expert" in str(s.spec)}
    assert cut == {f"block{b}.moe.{leaf}" for b in (1, 3) for leaf in ("wi", "bi", "wo", "bo")}
    for r in ranks:
        assert set(r["sharded"]) == cut
        for n, shape in r["shapes"].items():
            want = one["shapes"][n]
            assert shape == ((want[0] // 2,) + want[1:] if n in cut else want), n
            if n in cut:
                assert r["state_shapes"][n] == {"step": (), "exp_avg": shape, "exp_avg_sq": shape}


def test_moe_unetr_trains_with_sharded_experts(runs):
    """``tests/test_moe.py:189``: MoE UNETR trains three Adam steps on one
    batch over ``data=2 x expert=2`` with each rank holding 2 of the 4
    experts: the losses fall, equal one process's within 1e-5 and the JAX trainer's on
    a ``data=2 x expert=2`` mesh within 2e-5."""
    payload, ranks = runs["adam"]
    one = _one(runs, "adam")
    jcfg = JaxConfigNode(payload["cfg"])
    mesh = _jax_mesh()
    jparams = jax.tree_util.tree_map(jnp.asarray, UNETR_PARAMS)
    tx, lr = joptim.build_optimizer(jcfg.training, jparams)
    with mesh:
        jt = JaxSegTrainer(jcfg, mesh=mesh)
        jt.setup(JaxTrainState.create(apply_fn=JaxUNETR(**UNETR_JAX).apply, params=jparams, tx=tx), None,
                 joptim.EpochScheduler(jcfg.training, lr))
        ref = []
        for batch in payload["batches"]:
            jt.run_step(batch)
            ref.append(jt.flush_step_metrics()["loss"])
        wi = jt.state.params["block1"]["moe"]["wi"]
        assert wi.addressable_shards[0].data.shape[0] == 2  # the reference shards too
    for r in ranks:
        assert r["loss"][-1] < r["loss"][0]
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["loss"], ref, rtol=2e-5)


def test_training_steps_equal_one_process(runs):
    """Two SGD steps of the MoE UNETR at global batch 4 over ``data=2 x
    expert=2`` equal one process's; the gradients of the whole params
    (the router's included) are the same on the two ranks of an expert
    group bit for bit, with no all-reduce over the group to make them so."""
    _, ranks = runs["train"]
    one = _one(runs, "train")
    _steps_close(ranks, one)
    grads = [r["whole_grads"] for r in ranks]
    assert grads[0] and any(".router." in k for k in grads[0])
    for d in (0, 2):
        assert set(grads[d]) == set(grads[d + 1])
        for k in grads[d]:
            np.testing.assert_array_equal(grads[d][k], grads[d + 1][k], err_msg=k)


def test_training_steps_match_the_reference(runs):
    """The four-rank SGD steps against the JAX SegTrainer on the same MoE
    UNETR on a ``data=2 x expert=2`` mesh."""
    from multimodal_tta_tpu_torch.models.convert import from_flax

    payload, ranks = runs["train"]
    jcfg = JaxConfigNode(payload["cfg"])
    mesh = _jax_mesh()
    jparams = jax.tree_util.tree_map(jnp.asarray, UNETR_PARAMS)
    tx, lr = joptim.build_optimizer(jcfg.training, jparams)
    with mesh:
        jt = JaxSegTrainer(jcfg, mesh=mesh)
        jt.setup(JaxTrainState.create(apply_fn=JaxUNETR(**UNETR_JAX).apply, params=jparams, tx=tx), None,
                 joptim.EpochScheduler(jcfg.training, lr))
        for i, batch in enumerate(payload["batches"]):
            jt.run_step(batch)
            np.testing.assert_allclose(ranks[0]["loss"][i], jt.flush_step_metrics()["loss"], rtol=2e-5)
            ref = from_flax(jax.tree_util.tree_map(np.asarray, jt.state.params))
            for n, p in ranks[0]["params"][i].items():
                np.testing.assert_allclose(p, ref[n].numpy(), rtol=1e-5, atol=5e-6, err_msg=f"{n} after step {i}")


def test_checkpoint_moves_between_the_expert_axis_and_one_process(runs):
    """Rank 0 writes the whole tree of an ``expert=2`` run (every expert and
    its momentum gathered); one process resumes it and takes the next step
    as the ranks did. A one-process checkpoint resumes over the four ranks
    the same way."""
    payload, ranks = runs["train"]
    resumed = CASES["train"](None, **dict(payload, batches=[], checkpoint=None, resume=payload["checkpoint"]))
    np.testing.assert_allclose(resumed["loss"], ranks[0]["loss"][2:], rtol=1e-5)
    for k, v in resumed["params"][0].items():
        np.testing.assert_allclose(v, ranks[0]["params"][2][k], rtol=1e-5, atol=2e-6, err_msg=k)
    raw = flax_msgpack.load(payload["checkpoint"] + ".msgpack")  # the reference's format, whole
    assert raw["params"]["block1"]["moe"]["wi"].shape == (4, 16, 32)
    sgd = raw["opt_state"]["inner_state"]
    trace = sgd[max(sgd, key=int)]["0"]["trace"]  # after the masked decay, where the run decays
    assert trace["block1"]["moe"]["wi"].shape == (4, 16, 32) and bool(trace["block1"]["moe"]["wi"].any())
    back = runs["resume_one"][1]
    one = _one(runs, "resume_one")
    _steps_close(back, one)


def test_zero1_over_the_data_group_of_each_expert_rank(runs):
    """``tests/test_zero1.py:129``: ZeRO-1 partitions the optimizer state
    over the data group of each expert rank (whole tensors, where the
    reference shards a later dim of each moment over ``data``): the same
    losses and params bit for bit as without it; a rank's partition holds
    its share of the experts' momentum, and the two ranks of a data group
    together hold every tensor's; its checkpoint resumes in one process."""
    payload, ranks = runs["zero1"]
    plain = runs["train"][1]
    for r, p in zip(ranks, plain):
        assert r["loss"] == p["loss"]
        for a, b in zip(r["params"], p["params"]):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for e in (0, 1):  # ranks (0, e) and (1, e) form a data group
        held = set(ranks[e]["state_shapes"]) | set(ranks[2 + e]["state_shapes"])
        assert held == set(ranks[e]["shapes"]) and not set(ranks[e]["state_shapes"]) & set(ranks[2 + e]["state_shapes"])
        for r in (ranks[e], ranks[2 + e]):
            for n, st in r["state_shapes"].items():
                assert st["momentum_buffer"] == r["shapes"][n]
    mesh = jax_make_mesh(jax.devices()[:4], data=2, expert=2)
    state = JaxTrainState.create(apply_fn=JaxUNETR(**UNETR_JAX).apply,
                                 params=jax.tree_util.tree_map(jnp.asarray, UNETR_PARAMS), tx=optax.adam(1e-3))
    spec = train_state_sharding(mesh, state, zero1=True).opt_state[0].mu["block1"]["moe"]["wi"].spec
    assert spec[0] == "expert" and "data" in tuple(spec)[1:]  # what the reference does instead
    resumed = CASES["train"](None, **dict(payload, cfg=SGD_CFG, batches=[], checkpoint=None,
                                          resume=payload["checkpoint"]))
    np.testing.assert_allclose(resumed["loss"], ranks[0]["loss"][2:], rtol=1e-5)
    for k, v in resumed["params"][0].items():
        np.testing.assert_allclose(v, ranks[0]["params"][2][k], rtol=1e-5, atol=2e-6, err_msg=k)


# ---------------------------------------------------------------------------
# Adafactor over a cut axis


@pytest.mark.parametrize("name", ["adafactor_expert", "adafactor_model"])
def test_adafactor_over_a_cut_axis_equals_one_process(runs, name):
    """Two Adafactor steps (factored at dims of 4 and more, momentum,
    parameter scale) of the flagship's bottleneck MoE over ``expert=2`` and
    of UNETR over ``model=2`` equal one process's: the block-RMS clip, the
    parameter scale and the statistics along a cut dim read whole tensors
    through sums over the cut's group."""
    _, ranks = runs[name]
    one = _one(runs, name)
    assert ranks[0]["sharded"]
    _steps_close(ranks, one)


def test_adafactor_cut_statistics_equal_one_process(runs):
    """Adafactor on tensors cut in half over the expert group: a row
    statistic along the cut, a column statistic along it, per-expert
    statistics and an unfactored vector, three steps with momentum and the
    parameter scale: the params and every state tensor (gathered whole
    through ``state_cut``) equal one process's on the whole tensors."""
    _, ranks = runs["adafactor_cuts"]
    one = _one(runs, "adafactor_cuts")
    for r in ranks:
        for k, v in one["params"].items():
            np.testing.assert_allclose(r["params"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
        for i, st in one["state"].items():
            assert set(r["state"][i]) == set(st)
            for k, v in st.items():
                np.testing.assert_allclose(r["state"][i][k], v, rtol=1e-5, atol=1e-7, err_msg=f"{i} {k}")


# ---------------------------------------------------------------------------
# Tent and evaluation


@pytest.mark.parametrize("mode", ["inline", "post"])
def test_tent_over_the_expert_axis_equals_one_process(runs, mode):
    """Tent (two steps, online inline and strict post, a ragged second
    batch) on the MoE UNETR over ``data=2 x expert=2`` adapts the norm
    affines as one process does; the experts stay frozen and cut (2 of 4 a
    rank)."""
    _, ranks = runs[f"tent_{mode}"]
    one = _one(runs, f"tent_{mode}")
    assert ranks[0]["adapted"] == one["adapted"] and not any(".moe." in n for n in one["adapted"])
    for r in ranks:
        assert r["experts_frozen"] and r["expert_rows"] == [2] and one["expert_rows"] == [4]
        for a, b in zip(r["ents"], one["ents"]):
            np.testing.assert_allclose(a, b, rtol=1e-5)
        for k, v in one["state"].items():
            np.testing.assert_allclose(r["state"][k], v, rtol=1e-5, atol=2e-6, err_msg=k)
        for a, b in zip(r["preds"], one["preds"]):
            assert (a == b).mean() >= 0.9999


def test_evaluate_with_tent_over_the_expert_axis(runs):
    """``TTAEngine.evaluate`` with strict Tent on the MoE UNETR over ``data=2
    x expert=2``: the metrics and the adapted state of one process."""
    _, ranks = runs["evaluate"]
    one = _one(runs, "evaluate")
    for r in ranks:
        assert set(r["metrics"]) == set(one["metrics"])
        for k, v in one["metrics"].items():
            if isinstance(v, float):
                np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
        for k, v in one["state"].items():
            np.testing.assert_allclose(r["state"][k], v, rtol=1e-5, atol=2e-6, err_msg=k)


def test_chip_smoke_expert_axis_phase_at_fixture_size(runs):
    """chip_smoke.py's phase 26 on the CPU at fixture size (a MoE UNETR of
    hidden 32 and 4 layers, 4 experts, on [32,32,32]): its one process
    (``expert_axis_prepare``), its rank side in the file's four gloo ranks
    on ``data=2 x expert=2`` (``run_axes_jobs``), and ``expert_axis_compare``
    within the phase's limits (the first Adafactor step's factored moves
    among them); each rank holds half the experts and half their Adam
    moments."""
    import chip_smoke

    out = chip_smoke.expert_axis_compare("cpu", runs["phase26"][0])
    assert out["logit_max_abs"] <= chip_smoke.TP_LOGIT_REL * out["logit_scale"]
    assert max(out["train"]["grad_rel_l2"], out["train"]["router_grad_rel_l2"]) <= chip_smoke.DP_GRAD_REL
    for opt in ("adam", "adafactor"):
        assert out["train"][opt]["loss_max_rel"] <= chip_smoke.DP_LOSS_REL
    assert out["train"]["adafactor_first_delta_rel_l2"] <= chip_smoke.DP_DELTA_REL
    assert out["train"]["adafactor_cut_rule_rel"] <= chip_smoke.EP_CUT_RULE_REL
    assert out["train"]["route_flips"] == [[0] * 4] * 4  # 2 MoE blocks, forward and remat, on each rank
    assert out["train"]["adafactor_factored_experts"] == 2 * 2  # wi and wo of the 2 MoE blocks
    assert set(out["tent"]) == {"inline", "post"} and out["evaluate"]["metrics_max_rel"] <= chip_smoke.DP_LOSS_REL
    assert out["launches"] == {"forward": 0, "backward": 0, "minplus": 0}
    for r in out["ranks"]:
        assert r["expert_bytes"] * 2 == out["one"]["expert_bytes"]
        assert r["expert_moment_bytes"] * 2 == out["one"]["expert_moment_bytes"]

