"""The data axis over ranks (``multimodal_tta_tpu_torch/parallel/``, the
ranks of ``SegTrainer``, ``TTAEngine``, ``TentAdapter``, the stream, the
device cache and the checkpoints): two gloo ranks on the CPU against the
one-process port on the same global batches, and against the JAX package on
a ``data=2`` mesh of its 8 CPU devices.

One spawn (``tests/_torch_dp_worker.py``, which imports no JAX) runs every
two-rank case; the one-process runs are the same case functions here.

Tolerances:
  - two ranks vs one process: losses and entropies within 1e-5 relative;
    the params' moves over the steps, the running statistics and the MoE
    aux within 1e-5 relative L2 over all their tensors together (measured
    up to 9.1e-7: the ranks add their partial sums, one process reduces the
    batch, f32 sums in another order); Tent's adapted params within 1e-5
    relative plus 2e-6 absolute (``assert_steps_match``'s); metrics within
    1e-6; predictions equal on >= 99.99% of voxels;
  - zero1 vs plain over two ranks: equal (the update is the same arithmetic
    on the same numbers);
  - against the JAX package: ``tests/_torch_port.py:assert_steps_match``'s
    tolerances for training (loss 2e-5, params 1e-5 relative + 2e-6 x
    (step + 2) absolute under Adam), ``assert_adapted_close``'s 1e-3
    relative L2, 1e-5 entropies and 99.9% of voxels for Tent;
  - the sharded store: the reference's sample order exactly.
"""

import gzip
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core import optim as joptim
from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
from multimodal_tta_tpu.core.trainers.seg_trainer import SegTrainer as JaxSegTrainer
from multimodal_tta_tpu.data.device_cache import DeviceCachedLoader as JaxDeviceCachedLoader
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_tta_tpu.parallel.mesh import shard_batch as jax_shard_batch
from multimodal_tta_tpu.registry import get_tta_method as jax_get_tta_method
from multimodal_tta_tpu.tta.tent import TentAdapter as JaxTentAdapter
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.data.synthetic import make_hecktor_fixture
from multimodal_tta_tpu_torch.models.convert import unet3d_from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.parallel.distributed import spawn_ranks
from multimodal_tta_tpu_torch.parallel.mesh import pad_batch_to_multiple
from multimodal_tta_tpu_torch.registry import get_tta_method
from multimodal_tta_tpu_torch.tta.tent import TentAdapter, norm_param_mask

from _torch_dp_worker import CASES, IdDataset, fail_on_rank_one, hang, spawn
from _torch_port import (
    ADAM,
    DEVICE_TRANSFORM,
    SGD,
    JaxDraws,
    assert_adapted_close,
    assert_preds_close,
    jax_state,
    random_flax_params,
    trainer_config,
    tta_config,
)

torch.set_num_threads(2)

MK = dict(in_channels=2, num_classes=1, channels=(8, 16), strides=(2,), num_res_units=2)
SHAPE = (8, 16, 16, 2)
SURFACE = {"evaluation": {"seg": {"region_order": ["GTV"], "threshold": 0.3, "spacing": [1.0, 1.0, 1.0]},
                          "surface": {"enable": True, "nsd_tol": 1.0}, "loss": {"report_loss": True}}}


def _params(seed: int = 0, **kw):
    return random_flax_params(JaxUNet3D(**dict(MK, **kw)), (1,) + SHAPE, seed)


def _state(seed: int = 0, **kw):
    """Random port weights (a model with options), or the reference's
    random flax params carried across."""
    if kw:
        return UNet3D(**dict(MK, **kw), device="cpu", seed=seed).state_dict()
    return unet3d_from_flax(_params(seed))


# deep supervision needs two decoder levels
DS = dict(MK, channels=(8, 16, 32), strides=(2, 2), deep_supervision=1)


def _batches(sizes, seed: int, label: bool = True):
    rng = np.random.RandomState(seed)
    out = []
    for b in sizes:
        x = (rng.randn(b, *SHAPE) * 100).astype(np.float32)
        y = (rng.rand(b, *SHAPE[:-1], 1) > 0.7).astype(np.float32)
        out.append({"image": x, "label": y} if label else x)
    return out


def _eval_batches(sizes, seed):
    out = []
    for i, b in enumerate(_batches(sizes, seed)):
        b["domain"] = [("CHUS", "CHGJ")[(i + j) % 2] for j in range(len(b["image"]))]
        out.append(b)
    return out


ADAM_CFG = trainer_config(ADAM)
# Adafactor factors the (8, 16) widths' 2-D layouts only from 8 on
ADAFACTOR = {"optimizer": "adafactor", "optimizers": {"adafactor": {"lr": 1e-2, "weight_decay": 1e-4,
                                                                   "min_dim_size_to_factor": 8}}}
TRAIN = dict(cfg=ADAM_CFG, model_kw=MK, state=_state(1), batches=_batches([4, 4, 5], 1),
             device_transform=DEVICE_TRANSFORM)
MORE = _batches([4], 9)


def _tent_cfg(**tta):
    cfg = tta_config(**tta)
    cfg["training"]["compute_dtype"] = "float32"
    return cfg


def _predict_argv(tmp: str, run: str) -> list:
    """``cli.predict`` with SAR on a HECKTOR21 fixture of (16,16,16) volumes
    (three test cases: a batch of 2 and a ragged one), writing to
    ``<tmp>/pred_<run>``."""
    return [f"dataset.manifest_csv={tmp}/data/manifest.csv", "dataset.expected_shape=[16,16,16]",
            "dataset.val_per_center=1", "training.batch_size=2", "training.eval_batch_size=2",
            "training.num_workers=0", "training.compute_dtype=float32",
            "training.data.transforms.image_size=[16,16,16]", "model.channels=[2,4,8,16,32]",
            "model.num_res_units=1", "tta=sar", "tta.episodic=false", "tta.lr=0.05",
            f"task.save_dir={tmp}/outputs", f"task.run_name=predict_{run}", f"predict.out_dir={tmp}/pred_{run}"]


def _payloads(tmp):
    zero1_cfg = trainer_config(dict(ADAM, zero1=True))
    jp = _params(5)
    jd_adapter = TentAdapter(ConfigNode(JAX_TENT_CFG).tta, config=ConfigNode(JAX_TENT_CFG), device="cpu")
    jd_adapter._bind(UNet3D(**MK, device="cpu"))
    draws = JaxDraws(jd_adapter, jp)
    tent_batches = _batches([4, 4], 7, label=False)
    make_hecktor_fixture(f"{tmp}/data", shape=(16, 16, 16), centers={"CHUS": 3, "CHUM": 3, "CHGJ": 3})
    methods = {}
    for name, cfg in METHOD_CFGS.items():
        port = get_tta_method(cfg["tta"]["method"])(ConfigNode(cfg).tta, config=ConfigNode(cfg), device="cpu")
        port._bind(UNet3D(**MK, device="cpu"))
        md = JaxDraws(port, jp)
        post = name in POST_DRAWS
        methods[name] = ("adapter", dict(cfg=cfg, model_kw=MK, state=unet3d_from_flax(jp), batches=METHOD_BATCHES,
                                         n_valid=[4, 3], mode="post",
                                         draws=[md(x.shape, n, post=post) for x, n in zip(METHOD_BATCHES, [4, 3])],
                                         device_transform=DEVICE_TRANSFORM))
    return {
        "train": ("train", TRAIN),
        "zero1": ("train", dict(TRAIN, cfg=zero1_cfg, checkpoint=f"{tmp}/zero1", more=MORE)),
        "zero1_from_one": ("train", dict(TRAIN, cfg=zero1_cfg, batches=[], resume=f"{tmp}/one", more=MORE)),
        "zero1_adafactor": ("train", dict(TRAIN, cfg=trainer_config(dict(ADAFACTOR, zero1=True)))),
        "zero1_accum": ("train", dict(TRAIN, cfg=trainer_config(dict(ADAM, zero1=True, grad_accum=2)))),
        "zero1_orbax": ("train", dict(TRAIN, cfg=zero1_cfg, batches=TRAIN["batches"][:1],
                                      checkpoint=f"{tmp}/zero1_orbax", formats=("msgpack", "orbax"),
                                      frozen=("enc0.residual_proj.bias",))),
        "batchnorm": ("train", dict(cfg=trainer_config(SGD), model_kw=dict(MK, norm="BATCH"),
                                    state=_state(2, norm="BATCH"), batches=_batches([4, 5], 2))),
        "batchnorm_remat": ("train", dict(cfg=trainer_config(dict(SGD, remat=True)),
                                          model_kw=dict(MK, norm="BATCH", remat=True),
                                          state=_state(2, norm="BATCH"), batches=_batches([4, 5], 2))),
        "moe": ("train", dict(cfg=trainer_config(SGD, {"moe_experts": 4, "moe_aux_weight": 0.01}),
                              model_kw=dict(MK, moe_experts=4, moe_k=2), state=_state(3, moe_experts=4, moe_k=2),
                              batches=_batches([4, 5], 3))),
        "deep_supervision": ("train", dict(cfg=trainer_config(SGD, {"deep_supervision": 1, "strides": [2, 2]}),
                                           model_kw=DS, state=_state(4, **DS), batches=_batches([4, 5], 4))),
        "evaluate": ("evaluate", dict(cfg=dict(trainer_config({}), **SURFACE), model_kw=MK, state=_state(6),
                                      batches=_eval_batches([4, 4, 3], 6), device_transform=DEVICE_TRANSFORM)),
        "evaluate_tent": ("evaluate", dict(cfg=dict(_tent_cfg(episodic=False, lr=1e-2), **SURFACE), model_kw=MK,
                                           state=_state(6), batches=_eval_batches([4, 4, 3], 6),
                                           device_transform=DEVICE_TRANSFORM)),
        "evaluate_norm": ("evaluate", dict(cfg=dict(_tent_cfg(method="norm", episodic=False), **SURFACE),
                                           model_kw=dict(MK, norm="BATCH"), state=_state(2, norm="BATCH"),
                                           batches=_eval_batches([4, 3], 8), device_transform=DEVICE_TRANSFORM)),
        "tent_inline": ("tent", dict(cfg=_tent_cfg(episodic=False, steps=2, lr=1e-2,
                                                   early_stop={"enabled": True, "entropy_floor_ratio": FLOOR}),
                                     model_kw=MK, state=_state(7), batches=_batches([4, 4, 4], 7, label=False),
                                     n_valid=[4, 3, 4], mode="inline", device_transform=DEVICE_TRANSFORM)),
        "tent_strict_windows": ("tent", dict(
            cfg=_tent_cfg(steps=2, lr=5e-2, entropy_focus="uncertain", loss="entropy+consistency",
                          window={"enabled": True, "roi_size": [8, 8, 8], "windows_per_step": 2}),
            model_kw=MK, state=_state(8), batches=_batches([4, 4], 8, label=False), n_valid=[4, 3], mode="post",
            device_transform=DEVICE_TRANSFORM)),
        "tent_jax_draws": ("tent", dict(cfg=JAX_TENT_CFG, model_kw=MK, state=unet3d_from_flax(jp),
                                        batches=tent_batches, n_valid=[4, 3], mode="post",
                                        draws=[draws(x.shape, n) for x, n in zip(tent_batches, [4, 3])],
                                        device_transform=DEVICE_TRANSFORM)),
        "stream": ("stream", dict(cfg=_tent_cfg(episodic=False, lr=1e-2), model_kw=MK, state=_state(9),
                                  batches=_batches([3, 4, 1], 9, label=False), n_valid=[3, 4, 1],
                                  device_transform=DEVICE_TRANSFORM)),
        "sharded_store": ("sharded_store", dict(n=11, batch_size=4, seed=5, epochs=2)),
        "errors": ("errors", dict(cfg=_tent_cfg(), model_kw=MK, state=_state(0))),
        "evaluate_sar": ("evaluate", dict(cfg=dict(METHOD_CFGS["sar"], **SURFACE),
                                          model_kw=MK, state=_state(6), batches=_eval_batches([4, 3], 6),
                                          device_transform=DEVICE_TRANSFORM)),
        "predict": ("predict", dict(argv=_predict_argv(tmp, "ranks"))),
        **methods,
    }


# an early-stop floor that the second step of every batch crosses
FLOOR = 0.99999
# SAR's recovery floor (x H_max = ln 2): 0.6283, between the fixture's
# monitor scores of the first batch (0.6279, both steps reset) and of the
# second (0.6289, no reset, the params adapt)
SAR_FLOOR = 0.9065
# the other adapters, continual, each with the reference's draws: pl with a
# threshold that some voxels clear, eata's gate and Fisher, sar with a
# recovery floor that fires, cotta's teacher with restore and post views,
# memo's marginal with modality dropout and post views
METHOD_CFGS = {
    "pl": _tent_cfg(method="pl", steps=2, lr=1e-2, episodic=False, pl={"conf_threshold": 0.6}),
    "eata": _tent_cfg(method="eata", steps=2, lr=1e-2, episodic=False, entropy_focus="uncertain",
                      reliability={"margin_ratio": 1.0}, fisher={"batches": 1, "lambda": 50.0}),
    "sar": _tent_cfg(method="sar", steps=2, lr=0.2, episodic=False, rho=0.5, margin_ratio=1.0,
                     reset_floor_ratio=SAR_FLOOR),
    "cotta": _tent_cfg(method="cotta", steps=2, lr=1e-2, episodic=False, ema=0.9, n_views=2,
                       restore={"enabled": True, "prob": 0.2}),
    "memo": _tent_cfg(method="memo", steps=1, lr=1e-2, episodic=False, n_views=3, serve="marginal",
                      restore={"enabled": True, "prob": 0.2}, modality_dropout={"enabled": True, "prob": 0.5}),
}
POST_DRAWS = ("cotta", "memo")  # serve the teacher's / the marginal's post-update views
METHOD_BATCHES = _batches([4, 4], 11, label=False)
ADAPTERS = tuple(METHOD_CFGS)
JAX_TENT_CFG = _tent_cfg(steps=2, lr=1e-2, loss="entropy+consistency",
                         modality_dropout={"enabled": True, "prob": 0.5})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every two-rank case in one spawn: ``{name: (payload, [rank 0's,
    rank 1's result])}``; the one-process checkpoint that a zero1 run
    resumes from is written first."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    payloads = _payloads(tmp)
    CASES["train"](None, **dict(TRAIN, checkpoint=f"{tmp}/one"))
    ranks = spawn([c for c in payloads.values()], tmp, world=2, timeout=300)
    return {name: (payload, [ranks[0][i], ranks[1][i]])
            for i, (name, (_, payload)) in enumerate(payloads.items())}


# the cases whose batch statistics pool the padded rows of a ragged batch,
# as the reference's do on its padded global batch: one process is given
# that padded batch (and its valid count)
POOLED = ("batchnorm", "batchnorm_remat", "moe", "evaluate_norm")


def _padded(batch, tensors: bool):
    n = len(batch["image"])
    out, _ = pad_batch_to_multiple(dict(batch), 2)
    out["_n_valid"] = n
    if tensors:
        out["image"], out["label"] = torch.from_numpy(out["image"]), torch.from_numpy(out["label"])
    return out


def _one(runs, name, case):
    payload = runs[name][0]
    if name in POOLED:
        payload = dict(payload, batches=[_padded(b, case == "train") for b in payload["batches"]])
    return CASES[case](None, **payload)


def _close_params(got, want, what, exact: bool = False):
    """Every tensor within ``assert_steps_match``'s 1e-5 relative plus 2e-6
    absolute of ``want``'s, or equal."""
    assert set(got) == set(want)
    for k in want:
        if exact:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-6, err_msg=f"{what}: {k}")


def _rel_l2(got: dict, want: dict, base: dict = None) -> float:
    """The relative L2 of ``got - want`` over all their tensors together;
    with ``base``, of the moves ``got - base`` against ``want - base``."""
    assert set(got) == set(want)
    if not want:
        return 0.0
    ref = np.concatenate([(want[k] - (0 if base is None else base[k])).ravel() for k in want])
    apart = np.concatenate([(np.asarray(got[k]) - want[k]).ravel() for k in want])
    return float(np.linalg.norm(apart) / max(np.linalg.norm(ref), 1e-30))


def _same_on_both_ranks(r0, r1, key):
    for a, b in zip(r0[key], r1[key]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{key}: {k} differs between the ranks")


# ---------------------------------------------------------------------------
# training


@pytest.mark.parametrize("name", ["train", "zero1_adafactor", "zero1_accum", "batchnorm", "batchnorm_remat", "moe",
                                  "deep_supervision"])
def test_training_steps_equal_one_process(runs, name):
    """Each step over two ranks (the last batch ragged: 5 rows, rank 0 holds
    3 valid, rank 1 2 valid and a padded row) equals the one-process step on
    the global batch (padded, where BatchNorm or the MoE load balance pool
    its rows): losses, params, BatchNorm running statistics, the MoE aux and
    dropped share; both ranks hold the same params. ZeRO-1 wraps Adafactor
    and ``MultiSteps`` (``grad_accum`` 2) too; with remat a BatchNorm's
    recompute pools its sums again inside the backward."""
    r0, r1 = runs[name][1]
    one = _one(runs, name, "train")
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-5)
    assert r0["loss"] == r1["loss"]
    source = {k: v.numpy() for k, v in runs[name][0]["state"].items()}
    for i, (got, want) in enumerate(zip(r0["params"], one["params"])):
        assert _rel_l2(got, want, source) <= 1e-5, f"{name}: the params' moves after step {i}"
    _same_on_both_ranks(r0, r1, "params")
    for got, want in zip(r0["stats"], one["stats"]):
        assert _rel_l2(got, want) <= 1e-5, f"{name}: running statistics"
    if name.startswith("batchnorm"):
        assert r0["stats"][0]
    for got, want in zip(r0["moe"], one["moe"]):
        assert _rel_l2(got, want) <= 1e-5, f"{name}: MoE aux and dropped share"
    assert bool(r0["moe"]) == (name == "moe")


def test_training_steps_match_the_reference_on_a_data_mesh(runs):
    """The two-rank steps against the JAX SegTrainer on a ``data=2`` mesh of
    the 8 CPU devices (the ragged last batch padded to 6 there too)."""
    payload, (r0, _) = runs["train"]
    jcfg = JaxConfigNode(payload["cfg"])
    mesh = jax_make_mesh(jax.devices()[:2], data=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, _params(1))
    tx, lr = joptim.build_optimizer(jcfg.training, jparams)
    with mesh:
        jt = JaxSegTrainer(jcfg, mesh=mesh, device_transform=DEVICE_TRANSFORM)
        jt.setup(JaxTrainState.create(apply_fn=JaxUNet3D(**MK).apply, params=jparams, tx=tx), None,
                 joptim.EpochScheduler(jcfg.training, lr))
        for i, batch in enumerate(payload["batches"]):
            jt.run_step(batch)
            want = jt.flush_step_metrics()["loss"]
            np.testing.assert_allclose(r0["loss"][i], want, rtol=2e-5, err_msg=f"loss of step {i}")
            ref = unet3d_from_flax(jax.tree_util.tree_map(np.asarray, jt.state.params))
            for n, p in r0["params"][i].items():
                np.testing.assert_allclose(p, ref[n].numpy(), rtol=1e-5, atol=2e-6 * (i + 2),
                                           err_msg=f"{n} after step {i}")


def test_zero1_equals_plain_data_parallel(runs):
    """ZeRO-1 partitions the optimizer state, not the arithmetic: the same
    losses and params bit for bit, and each rank holds part of the state."""
    plain, zero = runs["train"][1][0], runs["zero1"][1]
    assert zero[0]["loss"][:3] == plain["loss"]
    for a, b in zip(zero[0]["params"], plain["params"]):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _same_on_both_ranks(zero[0], zero[1], "params")
    adam_state = 2 * 4 * sum(v.size for v in plain["params"][0].values())  # two f32 moments
    held = [r["saved_state_bytes"] for r in zero]
    assert all(0 < h < adam_state for h in held) and abs(sum(held) - adam_state) <= 8 * 64


def test_zero1_orbax_each_rank_writes_its_partition(runs):
    """A two-rank zero1 run with a frozen param (held by no optimizer)
    saves as msgpack (consolidated to rank 0) and as orbax (each rank the
    moments of its own partition, rank 0 the frozen param's): one process
    reads the orbax tree bitwise equal to the msgpack one, and the two
    ranks' databases hold disjoint, non-empty shares of the moments."""
    from multimodal_tta_tpu_torch.core import flax_msgpack, ocdbt, orbax_format

    def leaves(payload):
        return {".".join(k for k, _ in keys): v for keys, v in orbax_format.flatten(payload)}

    ckpt = runs["zero1_orbax"][0]["checkpoint"]
    want, got = leaves(flax_msgpack.load(ckpt + ".msgpack")), leaves(orbax_format.load(ckpt + ".orbax"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == v if isinstance(v, str) else torch.equal(got[k], torch.as_tensor(np.asarray(v))), k
    moments = []
    for rank in (0, 1):
        with ocdbt.Database(f"{ckpt}.orbax/ocdbt.process_{rank}") as db:
            moments.append({e.key.decode().rpartition("/")[0] for e in db.entries()
                            if e.key.startswith(b"opt_state.") and not e.key.endswith(b".zarray")})
    assert moments[0] and moments[1] and not moments[0] & moments[1]
    frozen = [n for n in moments[0] | moments[1] if n.endswith(".enc0.residual_proj.bias")]
    assert len(frozen) == 2 and all(n in moments[0] for n in frozen)  # mu and nu


def test_zero1_checkpoint_resumes_in_one_process_and_back(runs):
    """Rank 0 writes the consolidated state of a two-rank zero1 run; one
    process resumes it and takes the next step as the ranks did. A
    one-process checkpoint resumes over two zero1 ranks the same way."""
    payload, (r0, _) = runs["zero1"]
    tmp = payload["checkpoint"].rsplit("/", 1)[0]
    resumed = CASES["train"](None, **dict(payload, batches=[], checkpoint=None, resume=payload["checkpoint"]))
    np.testing.assert_allclose(resumed["loss"], r0["loss"][3:], rtol=1e-5)
    _close_params(resumed["params"][0], r0["params"][3], "resumed in one process")
    one = CASES["train"](None, **dict(TRAIN, batches=[], resume=f"{tmp}/one", more=MORE))
    back = runs["zero1_from_one"][1][0]
    np.testing.assert_allclose(back["loss"], one["loss"], rtol=1e-5)
    _close_params(back["params"][0], one["params"][0], "resumed over two ranks")


# ---------------------------------------------------------------------------
# evaluation and Tent


@pytest.mark.parametrize("name", ["evaluate", "evaluate_tent", "evaluate_norm"])
def test_evaluation_equals_one_process(runs, name):
    """``TTAEngine.evaluate`` over two ranks (batches of 4, 4 and a ragged
    3; two domains; Dice, IoU, the loss, HD95, ASD, NSD) returns on both
    ranks the metrics of one process: no adaptation, continual Tent, and
    norm on a BatchNorm model."""
    r0, r1 = runs[name][1]
    one = _one(runs, name, "evaluate")
    assert r0["metrics"] == r1["metrics"]
    assert set(r0["metrics"]) == set(one["metrics"]) and "dom/CHGJ/avg_hd95" in one["metrics"]
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    _close_params(r0["state"], one["state"], f"{name}: the model after evaluate", exact=True)


@pytest.mark.parametrize("name", ["tent_inline", "tent_strict_windows", "tent_jax_draws"])
def test_tent_over_ranks_equals_one_process(runs, name):
    """Tent over two ranks equals one process: inline continual with early
    stop (a ragged batch; the frozen steps and the gate entropies are the
    global ones), strict episodic with windows cut from the gathered batch
    and a consistency term, and modality dropout + consistency with the
    reference's draws handed over."""
    r0, r1 = runs[name][1]
    one = _one(runs, name, "tent")
    for a, b in zip(r0["ents"], one["ents"]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for a, b in zip(r0["ents"], r1["ents"]):
        np.testing.assert_array_equal(a, b)
    _close_params(r0["state"], one["state"], name)
    _close_params(r0["state"], r1["state"], f"{name}: rank 1", exact=True)
    np.testing.assert_allclose(r0["gate"], one["gate"], rtol=1e-5)
    for a, b in zip(r0["preds"], one["preds"]):
        assert (a == b).mean() >= 0.9999
    if name == "tent_inline":  # every batch's second step fell below the floor and froze
        assert all(e[1] < FLOOR * e[0] for e in one["ents"])


def test_tent_over_ranks_matches_the_reference_on_a_data_mesh(runs):
    """The two-rank adapter against the JAX TentAdapter on a ``data=2``
    mesh, both given the reference's draws."""
    payload, (r0, _) = runs["tent_jax_draws"]
    cfg = JaxConfigNode(payload["cfg"])
    mesh = jax_make_mesh(jax.devices()[:2], data=2)
    params = _params(5)
    state = jax_state(params, module=JaxUNet3D(**MK))
    with mesh:
        adapter = JaxTentAdapter(cfg.tta, config=cfg, mesh=mesh, device_transform=DEVICE_TRANSFORM)
        fn = adapter.make_adapt_predict_fn(state, threshold=0.3, predict_mode="post")
        cur, ents, preds = state, [], []
        for x, n in zip(payload["batches"], payload["n_valid"]):
            cur, pred = fn(cur, jax_shard_batch({"image": x}, mesh)["image"], n)
            ents.append(np.asarray(adapter._last_ents))
            preds.append(np.asarray(pred))
    adapted = unet3d_from_flax(jax.tree_util.tree_map(np.asarray, cur.params))
    norm = [n for n, m in norm_param_mask(UNet3D(**MK, device="cpu")).items() if m]
    assert_adapted_close({k: torch.from_numpy(v) for k, v in r0["state"].items()}, adapted,
                         unet3d_from_flax(params), norm)
    for a, b in zip(r0["ents"], ents):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert_preds_close(r0["preds"], preds)


@pytest.mark.parametrize("name", ADAPTERS)
def test_adapters_over_ranks_equal_one_process(runs, name):
    """pl, eata, sar, cotta and memo over two ranks (continual, strict, a
    ragged second batch, the reference's draws for the global batch) equal
    one process: entropies, adapted params, predictions, SAR's recovery
    resets and its EMA, CoTTA's teacher; both ranks hold the same adapted
    state, teacher and reset decisions without a broadcast."""
    r0, r1 = runs[name][1]
    one = _one(runs, name, "adapter")
    for a, b in zip(r0["ents"], one["ents"]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    _close_params(r0["state"], one["state"], name)
    for a, b in zip(r0["preds"], one["preds"]):
        assert (a == b).mean() >= 0.9999
    np.testing.assert_allclose(r0["em"], one["em"], rtol=1e-5)
    for ta, tb in zip(r0["teacher"], one["teacher"]):
        for a, b in zip(ta, tb):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6)
    assert r0["resets"] == one["resets"] == r1["resets"]
    for key in ("ents", "em"):
        np.testing.assert_array_equal(r0[key], r1[key])
    _close_params(r0["state"], r1["state"], f"{name}: rank 1", exact=True)
    for ta, tb in zip(r0["teacher"], r1["teacher"]):
        for a, b in zip(ta, tb):
            np.testing.assert_array_equal(a, b)
    if name == "sar":  # the recovery fired on both steps of the first batch only
        assert one["resets"] == [2, 0] and np.isnan(one["em"][0]) and not np.isnan(one["em"][1])
    if name == "cotta":
        assert len(one["teacher"]) == 2


@pytest.mark.parametrize("name", ADAPTERS)
def test_adapters_over_ranks_match_the_reference_on_a_data_mesh(runs, name):
    """The two-rank adapters against the JAX adapters of the same method on a
    ``data=2`` mesh, both given the reference's draws."""
    payload, (r0, _) = runs[name]
    cfg = JaxConfigNode(payload["cfg"])
    mesh = jax_make_mesh(jax.devices()[:2], data=2)
    params = _params(5)
    state = jax_state(params, module=JaxUNet3D(**MK))
    with mesh:
        adapter = jax_get_tta_method(cfg.tta.method)(cfg.tta, config=cfg, mesh=mesh,
                                                      device_transform=DEVICE_TRANSFORM)
        fn = adapter.make_adapt_predict_fn(state, threshold=0.3, predict_mode="post")
        cur, ents, preds = state, [], []
        for x, n in zip(payload["batches"], payload["n_valid"]):
            cur, pred = fn(cur, jax_shard_batch({"image": x}, mesh)["image"], n)
            ents.append(np.asarray(adapter._last_ents))
            preds.append(np.asarray(pred))
    adapted = unet3d_from_flax(jax.tree_util.tree_map(np.asarray, cur.params))
    assert_adapted_close({k: torch.from_numpy(v) for k, v in r0["state"].items()}, adapted,
                         unet3d_from_flax(params), r0["names"])
    for a, b in zip(r0["ents"], ents):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert_preds_close(r0["preds"], preds)


def test_evaluate_with_sar_over_ranks_equals_one_process(runs):
    """``TTAEngine.evaluate`` with continual SAR over two ranks returns the
    metrics of one process on both ranks and restores the model."""
    r0, r1 = runs["evaluate_sar"][1]
    one = _one(runs, "evaluate_sar", "evaluate")
    assert r0["metrics"] == r1["metrics"] and set(r0["metrics"]) == set(one["metrics"])
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    _close_params(r0["state"], one["state"], "evaluate_sar: the model after evaluate", exact=True)


def test_predict_cli_over_ranks_writes_what_one_process_writes(runs):
    """``cli.predict`` with continual SAR over two ranks writes the files and
    ``predictions.csv`` of one process: each rank adapts and writes its rows
    of every batch (three cases: a batch of 2 and a ragged one), and no case
    is written twice."""
    payload, (r0, r1) = runs["predict"]
    tmp = payload["argv"][0].split("=", 1)[1].rsplit("/data/", 1)[0]
    one = CASES["predict"](None, argv=_predict_argv(tmp, "one"))
    assert r0["rows"] == r1["rows"] == one["rows"] and len(one["rows"]) == 3
    got_dir, want_dir = f"{tmp}/pred_ranks", f"{tmp}/pred_one"
    with open(f"{got_dir}/predictions.csv", "rb") as f, open(f"{want_dir}/predictions.csv", "rb") as g:
        assert f.read() == g.read()
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and len(names) == 4
    for fname in names:
        if fname.endswith(".nii.gz"):  # the NIfTI bytes (the gzip header holds a time stamp)
            with gzip.open(f"{got_dir}/{fname}") as f, gzip.open(f"{want_dir}/{fname}") as g:
                assert f.read() == g.read(), fname


def test_stream_pads_ragged_batches_over_ranks(runs):
    """The stream controller pads batches of 3 and 1 to the data axis and
    returns the global batch's predictions, as one process does."""
    r0, r1 = runs["stream"][1]
    one = _one(runs, "stream", "stream")
    np.testing.assert_allclose(r0["ents"], one["ents"], rtol=1e-5)
    assert r0["ents"] == r1["ents"]
    for a, b in zip(r0["preds"], one["preds"]):
        assert a.shape == b.shape and (a == b).mean() >= 0.9999


def test_what_the_data_axis_refuses(runs):
    """The serving artifact refuses a mesh by design, as the reference's
    ``serving/export.py`` does: it is one device's, and a deployment over
    several replicates it. Every method builds its engine over the ranks."""
    out = runs["errors"][1][0]
    assert out["pl"] is None
    assert out["engines"] == {"tent": "TentAdapter", "pl": "PseudoLabelAdapter", "eata": "EataAdapter",
                              "norm": "NormAdapter", "sar": "SarAdapter", "cotta": "CottaAdapter",
                              "memo": "MemoAdapter"}
    assert "ValueError" in out["artifact"] and "single-device serving artifact" in out["artifact"]
    assert "windows_per_step=3 must divide by the data axis (2)" in out["windows"]
    assert "sync_over_mesh=false is not supported" in out["sync"]


# ---------------------------------------------------------------------------
# the sharded store and the launch


def test_sharded_store_follows_the_reference_order(runs):
    """Rank r's batches are the rows ``[r*B/2, (r+1)*B/2)`` of the JAX
    sharded store's global batches on a ``data=2`` mesh, epoch by epoch:
    each rank stores ``ceil(11/2) = 6`` samples (the tail wrapped), every
    sample is seen in an epoch, and the reference's two errors."""
    payload, ranks = runs["sharded_store"]
    mesh = jax_make_mesh(jax.devices()[:2], data=2)
    ref = JaxDeviceCachedLoader(IdDataset(payload["n"]), batch_size=payload["batch_size"], shuffle=True,
                                drop_last=True, seed=payload["seed"], mesh=mesh, shard_store=True,
                                image_dtype=np.float16)
    want = [[np.asarray(b["image"])[:, 0, 0, 0, 0].astype(int).tolist() for b in ref]
            for _ in range(payload["epochs"])]
    half = payload["batch_size"] // 2
    for r, got in enumerate(ranks):
        assert got["sharded"] and got["store_rows"] == 6 and got["len"] == len(ref) == 3
        for e, epoch in enumerate(got["epochs"]):
            assert [ids for ids, _ in epoch] == [w[r * half:(r + 1) * half] for w in want[e]]
            assert all(n == payload["batch_size"] for _, n in epoch)
    for e in range(payload["epochs"]):
        seen = {i for r in ranks for ids, _ in r["epochs"][e] for i in ids}
        assert seen == set(range(payload["n"]))
    assert "drop_last" in ranks[0]["errors"][0] and "divisible by the data axis" in ranks[0]["errors"][1]


def test_launch_from_the_environment_and_a_failed_rendezvous(tmp_path):
    """Without torchrun's environment nothing starts; from it a one-rank
    group starts over TCP on localhost; ``WORLD_SIZE`` without an address
    raises; a rendezvous that no second rank joins raises after the
    group's timeout instead of going on alone."""
    out = spawn([("launch", {"store": str(tmp_path / "lonely")})], str(tmp_path), world=1, timeout=120)[0][0]
    assert out["no_launch"] is False and out["initialized_after_no_launch"] is False
    assert "MASTER_ADDR" in out["missing_address"]
    assert out["torchrun_env"] is True and out["rank_world_backend"] == (0, 1, "gloo")
    assert out["mesh"] == (1, 0, "cpu")
    assert out["failed_rendezvous"] and "rendezvous failed" in out["failed_rendezvous"]
    assert out["failed_rendezvous_s"] < 60 and out["initialized_after_failure"] is False


def test_chip_smoke_data_parallel_phase_at_fixture_size(tmp_path):
    """chip_smoke.py's phase 22 on the CPU at fixture size (channels 4..64 on
    [16,32,32]): two spawned gloo ranks against one process on the same
    global batches of the sharded store, within the phase's own limits
    (``chip_smoke.DP_*``); no kernel launches on the CPU."""
    import chip_smoke

    out = chip_smoke.data_parallel_phase("cpu", str(tmp_path / "dp"), shape=(16, 32, 32),
                                         channels=(4, 8, 16, 32, 64), volumes=16, threads=1)
    c = out["compare"]
    assert out["backend"] == "gloo" and c["ranks"] == 2 and len(c["losses"]["one"]) == 2
    assert c["losses"]["max_rel"] <= chip_smoke.DP_LOSS_REL and c["val_max_abs"] <= chip_smoke.DP_METRIC_ABS
    # the witness: the ranks' gradients are one process's two half-batch passes, added
    assert c["params"]["ranks_vs_two_half_passes"] <= chip_smoke.DP_GRAD_RANKS_REL
    assert c["params"]["two_half_passes_vs_batch_8"] <= chip_smoke.DP_GRAD_REL
    assert out["launches"] == {"forward": 0, "backward": 0, "minplus": 0}
    assert [r["tag"] for r in out["ranks"]] == ["rank0", "rank1"]
    assert out["ranks"][0]["train_allreduce_bytes"] > 0 and out["ranks"][0]["checkpoints"]
    held = [r["optimizer_state_bytes"] for r in out["ranks"]]
    assert max(held) < out["one"]["optimizer_state_bytes"] <= sum(held)


def test_a_failing_or_hung_rank_fails_the_run(tmp_path):
    """``spawn_ranks`` drops no rank's exception: a rank that raises stops
    the others and the call raises with its traceback; a rank past the time
    limit is killed and named."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1:.*rank 1 failed on purpose"):
        spawn_ranks(fail_on_rank_one, 2, str(tmp_path))
    with pytest.raises(RuntimeError, match=r"rank 0: exit code -9 \(stopped at the 3.0 s limit\)"):
        spawn_ranks(hang, 1, str(tmp_path), timeout=3.0)
    assert time.monotonic() - t0 < 45


def test_chip_smoke_adapters_phase_at_fixture_size(tmp_path):
    """chip_smoke.py's phase 24 on the CPU at fixture size (channels 4..64 on
    [16,32,32]): two spawned gloo ranks against one process, every method
    episodic and continual within the phase's limits (the metrics; the
    entropies, adapted tensors and CoTTA's teacher after each batch), SAR's
    open floor resetting once a batch, no kernel launches on the CPU."""
    import chip_smoke

    out = chip_smoke.adapters_phase("cpu", str(tmp_path / "ad"), shape=(16, 32, 32), channels=(4, 8, 16, 32, 64),
                                    threads=1)
    assert sorted(out["compare"]) == sorted(f"{m}_{mode}" for m in chip_smoke.AD_METHODS
                                            for mode in ("episodic", "continual"))
    assert out["compare"]["sar_episodic"]["resets"] == chip_smoke.AD_BATCHES
    assert all(c["metrics_max_abs"] <= chip_smoke.DP_METRIC_ABS for c in out["compare"].values())
    assert all(c["adapted"] == 36 and c["ents_max_rel"] <= chip_smoke.DP_LOSS_REL
               and max(c["delta_rel_l2"], c["teacher_rel_l2"]) <= chip_smoke.DP_DELTA_REL for c in out["compare"].values())
    assert [k for k, c in out["compare"].items() if c["teacher"]] == ["cotta_episodic", "cotta_continual"]
    assert out["launches"] == {"forward": 0, "backward": 0, "minplus": 0}
    assert [r["tag"] for r in out["ranks"]] == ["rank0", "rank1"]
    assert set(out["ranks"][0]["bf16_ms"]) == set(chip_smoke.AD_METHODS)
