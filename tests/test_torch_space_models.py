"""The space axis for every conv segmenter, every norm and the training
options (``parallel/space.py`` through ``models/unet_multimodal_latefusion.py``,
``unet3d_ws.py``, ``segresnet.py``, ``unet3d.py``'s deep supervision and
bottleneck MoE, ``moe.py`` over a split token axis, ``layers.py``'s GroupNorm,
LayerNorm and BatchNorm over a split depth, GWDL and distillation in
``SegTrainer``, Tent and ``norm`` on a BatchNorm model, ``TTAEngine.evaluate``):
four gloo ranks on the CPU on a ``data=2 x space=2`` mesh against the
one-process port on the same global batches, and the new models against the
JAX package on a ``data=1 x space=2`` mesh of its CPU devices.

One spawn (``tests/_torch_sm_worker.py``, which imports no JAX) runs every
rank case, and the same case functions in one more process without a mesh,
while the JAX references run in threads here. Each fixture keeps at least
one level split and one whole over the two space ranks (``test_fixture_levels``):
depth 16 with strides 2, 2, 2 splits 16, 8 and 4 and keeps the 2-plane level
whole; the deep-supervision fixture (depth 8) puts ``ds1`` on a split level
and ``ds2`` and the MoE bottleneck on whole ones; the split MoE fixture
(depth 16, strides 2, 2) gives each rank 2 bottleneck planes; UNet3D-WS
splits its stem level at depth 16 and keeps it whole at depth 4.

Tolerances (``tests/test_torch_space_parallel.py``'s): ranks vs one process
(f32): losses and entropies within 1e-5 relative; the first step's
gradients summed over the ranks within 1e-5 relative L2 over all tensors
together; params after the steps within 1e-5 relative plus 2e-6; running
statistics the same on every rank and within the params' bound of one
process's; predictions equal on >= 99.99% of voxels; metrics within 1e-6;
MoE routing (the dispatch tensor) identical; SegResNet's gradients and
moves within twice one process's own distance when only its group norms'
sums are reordered (a witness computed here, 2.03e-4). Against the JAX package: its
end-to-end bounds (losses 5e-4 relative plus 5e-5, the params' moves
within 1e-3 relative L2).
"""

import concurrent.futures
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core import optim as joptim
from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
from multimodal_tta_tpu.core.trainers.seg_trainer import SegTrainer as JaxSegTrainer
from multimodal_tta_tpu.models.segresnet import SegResNet as JaxSegResNet
from multimodal_tta_tpu.models.unet3d_ws import UNet3DWS as JaxUNet3DWS
from multimodal_tta_tpu.models.unet_multimodal_latefusion import MultimodalUNetLateFusion as JaxLate
from multimodal_tta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_tta_tpu_torch.core.checkpoint import save_checkpoint
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.models import layers
from multimodal_tta_tpu_torch.models.convert import from_flax
from multimodal_tta_tpu_torch.parallel import space as sp
from multimodal_tta_tpu_torch.registry import get_model

import _torch_sm_worker as sm_worker
from _torch_sm_worker import spawn
from _torch_port import DEVICE_TRANSFORM, SGD, random_flax_params, trainer_config, tta_config

torch.set_num_threads(2)

DATA, SPACE = 2, 2
FLAG = dict(in_channels=2, num_classes=1, channels=(4, 8, 16, 32), strides=(2, 2, 2), num_res_units=2)
SHAPE = (16, 16, 16, 2)
LATE = dict(num_modalities=4, num_classes=3, channels=(4, 8, 16, 32), strides=(2, 2, 2), num_res_units=2)
LATE_SHAPE = (16, 16, 16, 4)
WS = dict(in_channels=2, num_classes=1, channels=(4, 8, 16, 32, 64), strides=(2, 2, 2, 2), num_res_units=2)
WS_THIN = dict(in_channels=2, num_classes=1, channels=(4, 8, 16), strides=(2, 2), num_res_units=2)
WS_THIN_SHAPE = (4, 16, 16, 2)  # the stem level (2 planes) whole
SEGRES = dict(in_channels=2, num_classes=1, init_filters=4, blocks_down=(1, 2, 2, 4), blocks_up=(1, 1, 1))
DS = dict(FLAG, deep_supervision=2, moe_experts=4, moe_k=1)
DS_SHAPE = (8, 16, 16, 2)  # levels 8, 4 split; 2 (ds2) and 1 (the MoE bottleneck) whole
MOE_SPLIT = dict(in_channels=2, num_classes=1, channels=(4, 8, 16), strides=(2, 2), num_res_units=2,
                 deep_supervision=1, moe_experts=4, moe_k=2)  # a 4-plane bottleneck: 2 a rank
GWDL = dict(FLAG, num_classes=3)
GWDL_CRITERION = {"name": "gwdl", "softmax": True, "sigmoid": False, "lambda_ce": 0.5, "ce_weight": [1.0, 2.0, 3.0],
                  "distance_matrix": [[0.0, 1.0, 1.0], [1.0, 0.0, 0.5], [1.0, 0.5, 0.0]]}
BRATS_CRITERION = {"task": "multilabel", "lambda_dice": 1.0, "lambda_ce": 1.0, "include_background": True,
                   "sigmoid": True}
BRATS = {"normalize": False}
SURFACE = {"evaluation": {"seg": {"region_order": ["GTV"], "threshold": 0.3, "spacing": [1.0, 1.0, 1.0]},
                          "surface": {"enable": True, "nsd_tol": 1.0}, "loss": {"report_loss": True}}}


def _cfg(model: dict = None, remat=False, criterion=None, **training):
    cfg = trainer_config(dict(SGD, remat=remat, **training), model={
        k: list(v) if isinstance(v, tuple) else v for k, v in (model or {}).items()})
    if criterion is not None:
        cfg["training"]["criterion"] = criterion
    return cfg


def _batches(sizes, seed: int, shape=SHAPE, classes: int = 1, label: bool = True, labels: str = "mask"):
    """Global host batches from a seed: images ``[b, *shape]``; labels as
    ``[b, D, H, W, classes]`` masks or (``labels="map"``) class maps."""
    rng = np.random.RandomState(seed)
    out = []
    for b in sizes:
        x = (rng.randn(b, *shape) * 100).astype(np.float32)
        if labels == "map":
            y = rng.randint(0, classes, size=(b,) + tuple(shape[:-1])).astype(np.int64)
        else:
            y = (rng.rand(b, *shape[:-1], classes) > 0.7).astype(np.float32)
        out.append({"image": x, "label": y} if label else x)
    return out


def _state(name: str, kw: dict, seed: int) -> dict:
    return {k: v.clone() for k, v in get_model(name)(**kw, device="cpu", seed=seed).state_dict().items()}


def _tent_cfg(**tta):
    cfg = tta_config(**tta)
    cfg["training"]["compute_dtype"] = "float32"
    return cfg


# the JAX references (late fusion, UNet3D-WS, SegResNet): flax params and the
# port's state from them
JAX_MODELS = {"late": (JaxLate, dict(LATE, remat=True), LATE_SHAPE, 21),
              "ws": (JaxUNet3DWS, WS, SHAPE, 22),
              "segresnet": (JaxSegResNet, dict(SEGRES, remat=2), SHAPE, 23)}


def _flax(name: str):
    module, kw, shape, seed = JAX_MODELS[name]
    return random_flax_params(module(**kw), (1,) + shape, seed)


def _teacher(path: str) -> str:
    """The distillation teacher (a flagship UNet3D) as the port's checkpoint."""
    model = get_model("unet")(**FLAG, device="cpu", seed=31)
    save_checkpoint(path, TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1)))
    return path


def _distill_cfg(path: str, focus: str) -> dict:
    teacher = {"name": "unet", **{k: list(v) if isinstance(v, tuple) else v for k, v in FLAG.items()}}
    cfg = _cfg(WS)
    cfg["training"]["distill"] = {"enabled": True, "checkpoint": path, "temperature": 2.0, "weight": 0.5,
                                  "focus": focus, "model": teacher}
    cfg["training"]["data"] = {"transforms": {"image_size": list(SHAPE[:3])}}
    return cfg


def _moe(k: int, cf: float, seed: int):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 32, 8).astype(np.float32)
    return ("moe", dict(x=x, w=rng.randn(4, 32, 8).astype(np.float32), hidden=8, mlp_dim=16, experts=4, k=k,
                        capacity_factor=cf, seed=seed))


def _payloads(root: str):
    teacher = _teacher(f"{root}/teacher")
    late_state, ws_state, segres_state = (from_flax(_flax(n)) for n in ("late", "ws", "segresnet"))
    tr = lambda cfg, name, kw, state, batches, dt=DEVICE_TRANSFORM: (  # noqa: E731
        "train", dict(cfg=cfg, name=name, model_kw=kw, state=state, batches=batches, device_transform=dt))
    return {
        "late": tr(_cfg(LATE, remat=True, criterion=BRATS_CRITERION), "unet_multimodal_late", dict(LATE, remat=True),
                   late_state, _batches([2, 2], 1, LATE_SHAPE, 3), BRATS),
        "ws": tr(_cfg(WS), "unet_ws", WS, ws_state, _batches([4, 3], 2)),
        "ws_thin": tr(_cfg(WS_THIN), "unet_ws", WS_THIN, _state("unet_ws", WS_THIN, 3),
                      _batches([2], 3, WS_THIN_SHAPE)),
        "segresnet": tr(_cfg(dict(SEGRES, remat=2)), "segresnet", dict(SEGRES, remat=2), segres_state,
                        _batches([4, 3], 4)),
        "group": tr(_cfg(dict(FLAG, norm="GROUP")), "unet", dict(FLAG, norm="GROUP"),
                    _state("unet", dict(FLAG, norm="GROUP"), 5), _batches([4, 3], 5)),
        "layer": tr(_cfg(dict(FLAG, norm="LAYER")), "unet", dict(FLAG, norm="LAYER"),
                    _state("unet", dict(FLAG, norm="LAYER"), 6), _batches([4], 6)),
        "batch": tr(_cfg(dict(FLAG, norm="BATCH"), remat=True), "unet", dict(FLAG, norm="BATCH", remat=True),
                    _state("unet", dict(FLAG, norm="BATCH"), 7), _batches([4, 4], 7)),
        "ds_moe_whole": tr(_cfg(DS), "unet", DS, _state("unet", DS, 8), _batches([4, 4], 8, DS_SHAPE)),
        "moe_split": tr(_cfg(MOE_SPLIT), "unet", MOE_SPLIT, _state("unet", MOE_SPLIT, 9), _batches([4, 4], 9)),
        "gwdl": tr(_cfg(GWDL, criterion=GWDL_CRITERION), "unet", GWDL, _state("unet", GWDL, 10),
                   _batches([4, 3], 10, classes=3, labels="map")),
        "distill_all": tr(_distill_cfg(teacher, "all"), "unet_ws", WS, ws_state, _batches([4], 11)),
        "distill_uncertain": tr(_distill_cfg(teacher, "uncertain"), "unet_ws", WS, ws_state, _batches([4], 12)),
        "moe_k1_drop": _moe(1, 0.5, 13),
        "moe_k2": _moe(2, 1.25, 14),
        "moe_k2_drop": _moe(2, 0.5, 15),
        "late_tent": ("tent", dict(cfg=_tent_cfg(lr=1e-2), name="unet_multimodal_late", model_kw=dict(LATE, remat=True),
                                   state=late_state, batches=_batches([2], 16, LATE_SHAPE, label=False), n_valid=[2],
                                   mode="post", device_transform=BRATS, threshold=0.5)),
        "segresnet_tent": ("tent", dict(cfg=_tent_cfg(episodic=False, steps=2, lr=1e-2), name="segresnet",
                                        model_kw=SEGRES, state=segres_state,
                                        batches=_batches([4], 17, label=False), n_valid=[3], mode="inline",
                                        device_transform=DEVICE_TRANSFORM)),
        "bn_tent": ("tent", dict(cfg=_tent_cfg(episodic=False, lr=1e-2), name="unet", model_kw=dict(FLAG, norm="BATCH"),
                                 state=_state("unet", dict(FLAG, norm="BATCH"), 18),
                                 batches=_batches([4, 4], 18, label=False), n_valid=[4, 3], mode="inline",
                                 device_transform=DEVICE_TRANSFORM)),
        "segresnet_eval": ("evaluate", dict(cfg=dict(_tent_cfg(episodic=False, lr=1e-2), **SURFACE), name="segresnet",
                                            model_kw=SEGRES, state=segres_state, batches=_batches([4, 3], 19),
                                            device_transform=DEVICE_TRANSFORM)),
        "bn_norm_eval": ("evaluate", dict(cfg=dict(_tent_cfg(method="norm", episodic=False), **SURFACE), name="unet",
                                          model_kw=dict(FLAG, norm="BATCH"),
                                          state=_state("unet", dict(FLAG, norm="BATCH"), 20),
                                          batches=_batches([4, 4], 20), device_transform=DEVICE_TRANSFORM)),
    }


TRAIN = ["late", "ws", "ws_thin", "segresnet", "group", "layer", "batch", "ds_moe_whole", "moe_split", "gwdl",
         "distill_all", "distill_uncertain"]
MOE = ["moe_k1_drop", "moe_k2", "moe_k2_drop"]


def _jax_train(name: str, payload: dict):
    """The JAX SegTrainer's first step on a ``data=1 x space=2`` mesh of
    the CPU devices: its loss and params."""
    module, kw, _, _ = JAX_MODELS[name]
    jcfg = JaxConfigNode(payload["cfg"])
    mesh = jax_make_mesh(jax.devices()[:2], data=1, space=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, _flax(name))
    tx, lr = joptim.build_optimizer(jcfg.training, jparams)
    with mesh:
        jt = JaxSegTrainer(jcfg, mesh=mesh, device_transform=payload["device_transform"])
        jt.setup(JaxTrainState.create(apply_fn=module(**kw).apply, params=jparams, tx=tx), None,
                 joptim.EpochScheduler(jcfg.training, lr))
        jt.run_step(payload["batches"][0])
        return jt.flush_step_metrics()["loss"], jax.tree_util.tree_map(np.asarray, jt.state.params)


def _written_out_group_norm(payload: dict) -> dict:
    """One process's first-step gradients of ``payload`` with every group
    norm taken by the split path's formula on the whole depth (one rank:
    no sums to meet) instead of ``F.group_norm``: the same function, its
    sums in another order. Their distance from the stock run is how far
    f32 rounding alone moves that step's gradients (the witness of
    SegResNet's bound)."""

    class One:
        size = 1

    def forward(self, x, relu=False, space=None):
        if self.groups is None:
            return stock(self, x, relu)
        y = layers._split_group_norm(x.float(), self.groups, self.scale, self.bias, self.epsilon, One())
        return (torch.relu(y) if relu else y).to(x.dtype)

    stock = layers.GroupNorm.forward
    with mock.patch.object(layers.GroupNorm, "forward", forward), \
            mock.patch.object(layers, "space_sum", lambda t, ax, grad=False: t):
        return sm_worker.train_case(None, **dict(payload, batches=payload["batches"][:1]))["grads"]


class _Runs:
    """The spawn in a thread and the JAX references (and SegResNet's
    witness) in threads of their own; ``[name]`` waits for the spawn:
    ``(payload, [each rank's result], the one process's result)``."""

    def __init__(self, tmp: str):
        self.payloads = _payloads(tmp)
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.future = self.pool.submit(spawn, list(self.payloads.values()), f"{tmp}/ranks", DATA, SPACE, 400)
        self.jax_pool = concurrent.futures.ThreadPoolExecutor(3)
        self.jax = {n: self.jax_pool.submit(_jax_train, n, self.payloads[n][1]) for n in JAX_MODELS}
        self.witness = self.jax_pool.submit(_written_out_group_norm, self.payloads["segresnet"][1])

    def __getitem__(self, name):
        ranks, one = self.future.result()
        i = list(self.payloads).index(name)
        return self.payloads[name][1], [r[i] for r in ranks], one[i]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sm")
    (tmp / "ranks").mkdir()
    r = _Runs(str(tmp))
    yield r
    r.pool.shutdown()
    r.jax_pool.shutdown()


def _rel_l2(got: dict, want: dict, base: dict = None) -> float:
    ref = np.concatenate([(want[k] - (0 if base is None else base[k])).ravel() for k in want])
    apart = np.concatenate([(np.asarray(got[k]) - want[k]).ravel() for k in want])
    return float(np.linalg.norm(apart) / max(np.linalg.norm(ref), 1e-30))


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        for a, b in zip(r[key], ranks[0][key]):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{key}: {k} differs between the ranks")


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw,shape,strides", [
    ("flagship", FLAG, SHAPE, FLAG["strides"]), ("late", LATE, LATE_SHAPE, LATE["strides"]),
    ("ws", WS, SHAPE, (2,) + WS["strides"][1:]), ("ws_thin", WS_THIN, WS_THIN_SHAPE, (2,) + WS_THIN["strides"][1:]),
    ("segresnet", SEGRES, SHAPE, (2, 2, 2)), ("ds", DS, DS_SHAPE, DS["strides"]),
    ("moe_split", MOE_SPLIT, SHAPE, MOE_SPLIT["strides"])])
def test_fixture_levels(name, kw, shape, strides):
    """Each fixture's levels over two space ranks (``space.level_axes``):
    at least one split and one whole, and the ones the cases rest on."""

    class Axis:
        size = SPACE

    split = [a is not None for a in sp.level_axes(Axis(), shape[0] // SPACE, strides)]
    want = {"flagship": [True, True, True, False], "late": [True, True, True, False],
            "ws": [True, True, True, False, False], "ws_thin": [True, False, False],
            "segresnet": [True, True, True, False], "ds": [True, True, False, False],
            "moe_split": [True, True, True]}[name]
    assert split == want


@pytest.mark.parametrize("name", TRAIN)
def test_training_equals_one_process(runs, name):
    """Each step over the 2x2 ranks (a second batch of 3 rows ragged: data
    rank 1 holds a padded row; 4 rows where a batch statistic pools the
    padded rows) equals one process's on the global batch: losses, the
    first step's gradients summed over the world, the params, the running
    statistics and the MoE scalars; every rank holds the same params and
    statistics. SegResNet's gradients, and its params' moves, are held to
    twice one process's own distance under a reordering of its group
    norms' sums (the witness, 2.03e-4 here: the stem's first norm sums
    gradient terms that nearly cancel on the residual stream)."""
    payload, ranks, one = runs[name]
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-5)
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)
    assert set(ranks[0]["grads"]) == set(one["grads"])
    if name == "segresnet":
        bound = max(1e-5, 2.0 * _rel_l2(runs.witness.result(), one["grads"]))
        source = {k: v.numpy() for k, v in payload["state"].items()}
        for got, want in zip(ranks[0]["params"], one["params"]):
            assert _rel_l2(got, want, source) <= bound
    else:
        bound = 1e-5
        for got, want in zip(ranks[0]["params"], one["params"]):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-6, err_msg=k)
    assert _rel_l2(ranks[0]["grads"], one["grads"]) <= bound
    for got, want in zip(ranks[0]["buffers"], one["buffers"]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-6, err_msg=k)
    _same_on_every_rank(ranks, "params")
    _same_on_every_rank(ranks, "buffers")
    for got, want in zip(ranks[0]["moe"], one["moe"]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert len(ranks[0]["moe"]) == len(one["moe"])
    if name == "batch":
        assert ranks[0]["buffers"] and any(k.endswith(".mean") for k in ranks[0]["buffers"][0])


@pytest.mark.parametrize("name", MOE)
def test_moe_over_a_split_token_axis_routes_as_one_process(runs, name):
    """``MoEMlp`` on each rank's block of tokens (k=1 and k=2, a capacity
    that drops tokens and one that does not): the dispatch tensor (routing
    and buffer positions, token for token) equals one process's, and the
    output, the input's and the params' gradients, the aux loss and the
    dropped share agree."""
    _, ranks, one = runs[name]
    for r in ranks:
        np.testing.assert_array_equal(r["dispatch"], one["dispatch"])
        np.testing.assert_allclose(r["y"], one["y"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["x_grad"], one["x_grad"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["aux"], one["aux"], rtol=1e-6)
        np.testing.assert_allclose(r["dropped"], one["dropped"], rtol=1e-6, atol=1e-7)
    assert _rel_l2(ranks[0]["grads"], one["grads"]) <= 1e-5
    if name.endswith("drop"):
        assert one["dropped"] > 0.0
    else:
        assert one["dropped"] == 0.0


@pytest.mark.parametrize("name", ["late_tent", "segresnet_tent", "bn_tent"])
def test_tent_equals_one_process(runs, name):
    """Episodic strict Tent on late fusion, continual inline Tent (2 steps,
    a ragged batch) on SegResNet and on the BatchNorm flagship (its
    statistics pooled over the data and space axes): entropies, adapted
    tensors and running statistics, gate entropies and the gathered
    predictions equal one process's; every rank agrees."""
    _, ranks, one = runs[name]
    for a, b in zip(ranks[0]["ents"], one["ents"]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for r in ranks[1:]:
        for a, b in zip(r["ents"], ranks[0]["ents"]):
            np.testing.assert_array_equal(a, b)
        for k in r["state"]:
            np.testing.assert_array_equal(r["state"][k], ranks[0]["state"][k], err_msg=k)
    for k, v in one["state"].items():
        np.testing.assert_allclose(ranks[0]["state"][k], v, rtol=1e-5, atol=2e-6, err_msg=k)
    np.testing.assert_allclose(ranks[0]["gate"], one["gate"], rtol=1e-5)
    for a, b in zip(ranks[0]["preds"], one["preds"]):
        assert a.shape == b.shape and (a == b).mean() >= 0.9999


@pytest.mark.parametrize("name", ["segresnet_eval", "bn_norm_eval"])
def test_evaluation_equals_one_process(runs, name):
    """``TTAEngine.evaluate`` with continual Tent on SegResNet and with
    ``norm`` on the BatchNorm flagship over the 2x2 ranks (a ragged batch;
    the surface metrics on the depth-gathered volumes) returns on every
    rank one process's metrics and leaves the model as it was."""
    _, ranks, one = runs[name]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    assert set(ranks[0]["metrics"]) == set(one["metrics"]) and "avg_hd95" in one["metrics"]
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    for k, v in one["state"].items():
        np.testing.assert_array_equal(ranks[0]["state"][k], v, err_msg=k)


@pytest.mark.parametrize("name", list(JAX_MODELS))
def test_new_models_match_the_reference_on_a_space_mesh(runs, name):
    """The 2x2 ranks' first step of late fusion, UNet3D-WS and SegResNet
    against the JAX SegTrainer's on a ``data=1 x space=2`` mesh of the CPU
    devices (the JAX end-to-end bounds)."""
    loss, params = runs.jax[name].result()
    payload, ranks, _ = runs[name]
    np.testing.assert_allclose(ranks[0]["loss"][0], loss, rtol=5e-4, atol=5e-5)
    source = {k: v.numpy() for k, v in payload["state"].items()}
    ref = {k: v.numpy() for k, v in from_flax(params).items()}
    got = ranks[0]["params"][0]
    assert _rel_l2(got, {k: ref[k] for k in got}, source) <= 1e-3
