"""The space axis (``multimodal_tta_tpu_torch/parallel/space.py`` and the
depth split through the models, the norm's split entries, the losses, the
intensity transform, ``SegTrainer``, Tent, ``seg_eval`` and the stream):
four gloo ranks on the CPU on a ``data=2 x space=2`` mesh against the
one-process port on the same global batches, and against the JAX package on
``data=1 x space=2`` and ``data=2 x space=2`` meshes of its CPU devices.

One spawn (``tests/_torch_sp_worker.py``, which imports no JAX) runs every
rank case, and the same case functions in one more process without a mesh
(the one-process run), in a thread of its own while the JAX references are
computed here. The
flagship fixture has depth 16 and strides 2, 2, 2: levels 16, 8 and 4 are
split over the two space ranks and the 2-plane bottleneck is whole, so the
halos, the split norm, the gather before the deepest stage and the slice
after its ``up`` all run.

Tolerances:
  - ranks vs one process (f32): losses and entropies within 1e-5 relative;
    the first step's gradients summed over the ranks within 1e-5 relative
    L2 over all tensors together (a gamma/beta or whole-level gradient
    counted twice would be off by its own size); params after the steps
    within 1e-5 relative plus 2e-6; predictions equal on >= 99.99% of
    voxels; metrics within 1e-6;
  - against the JAX package: its own end-to-end bounds (losses 5e-4
    relative plus 5e-5, Dice 2e-3 absolute), the params' moves within 1e-3
    relative L2, Tent's entropies within 1e-5 relative and
    ``assert_adapted_close``'s 1e-3 for the adapted tensors;
  - the split norm entries and the collectives against the one-process
    functions and ``jax.grad``: 1e-5 (f32 sums over slabs in another order).
"""

import concurrent.futures
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core import optim as joptim
from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
from multimodal_tta_tpu.core.trainers.seg_trainer import SegTrainer as JaxSegTrainer
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu.models.unet_multimodal_midfusion import MultimodalUNetMidFusion as JaxMid
from multimodal_tta_tpu.pallas.fused_instance_norm import instance_norm_reference
from multimodal_tta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_tta_tpu.parallel.mesh import shard_batch as jax_shard_batch
from multimodal_tta_tpu.tta.tent import TentAdapter as JaxTentAdapter
from multimodal_tta_tpu_torch.models.convert import from_flax, unet3d_from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.tta.tent import norm_param_mask

from _torch_sp_worker import spawn
from _torch_port import (
    DEVICE_TRANSFORM,
    assert_adapted_close,
    assert_preds_close,
    jax_state,
    random_flax_params,
    trainer_config,
    tta_config,
)

fin = importlib.import_module("multimodal_tta_tpu_torch.kernels.fused_instance_norm")
torch.set_num_threads(2)

DATA, SPACE = 2, 2
MK = dict(in_channels=2, num_classes=1, channels=(4, 8, 16, 32), strides=(2, 2, 2), num_res_units=2)
# 32 x 32 planes: the 2-plane bottleneck keeps 32 voxels a norm (over 2, a
# norm's gradient is ill-conditioned enough that f32 rounding shows at 1e-3)
SHAPE = (16, 32, 32, 2)
MID = dict(num_modalities=4, num_classes=3, channels=(4, 8, 16, 32, 64), strides=(2, 2, 2, 2), num_res_units=2)
MID_SHAPE = (16, 16, 16, 4)
SGD = {"optimizer": "sgd", "optimizers": {"sgd": {"lr": 0.01, "momentum": 0.9, "weight_decay": 1e-3}}}
MID_CRITERION = {"task": "multilabel", "lambda_dice": 1.0, "lambda_ce": 1.0, "include_background": True,
                 "sigmoid": True}
SURFACE = {"evaluation": {"seg": {"region_order": ["GTV"], "threshold": 0.3, "spacing": [1.0, 1.0, 1.0]},
                          "surface": {"enable": True, "nsd_tol": 1.0}, "loss": {"report_loss": True}}}


def _params(seed: int):
    return random_flax_params(JaxUNet3D(**MK), (1,) + SHAPE, seed)


def _mid_params(seed: int):
    return random_flax_params(JaxMid(**MID, remat=True), (1,) + MID_SHAPE, seed)


def _batches(sizes, seed: int, shape=SHAPE, classes: int = 1, label: bool = True):
    rng = np.random.RandomState(seed)
    out = []
    for b in sizes:
        x = (rng.randn(b, *shape) * 100).astype(np.float32)
        y = (rng.rand(b, *shape[:-1], classes) > 0.7).astype(np.float32)
        out.append({"image": x, "label": y} if label else x)
    return out


def _tent_cfg(**tta):
    cfg = tta_config(**tta)
    cfg["training"]["compute_dtype"] = "float32"
    return cfg


TRAIN_CFG = trainer_config(SGD)
MID_CFG = {"task": {"seed": 0}, "training": {**SGD, "remat": True, "criterion": MID_CRITERION,
                                             "compute_dtype": "float32",
                                             "param_groups": {"no_decay_keys": ["bias", "norm", "scale"],
                                                              "treat_1d_as_no_decay": True}}}
BRATS = {"normalize": False}


def _payloads():
    p1, pm = _params(1), _mid_params(2)
    return {
        "train": ("train", dict(cfg=TRAIN_CFG, name="unet", model_kw=MK, state=unet3d_from_flax(p1),
                                batches=_batches([4, 3], 1), device_transform=DEVICE_TRANSFORM)),
        "train_mid": ("train", dict(cfg=MID_CFG, name="unet_multimodal_midfusion", model_kw=dict(MID, remat=True),
                                    state=from_flax(pm), batches=_batches([2], 2, MID_SHAPE, 3),
                                    device_transform=BRATS)),
        "tent_inline": ("tent", dict(cfg=_tent_cfg(episodic=False, steps=2, lr=1e-2), name="unet", model_kw=MK,
                                     state=unet3d_from_flax(_params(3)), batches=_batches([4, 4], 3, label=False),
                                     n_valid=[4, 3], mode="inline", device_transform=DEVICE_TRANSFORM)),
        "tent_post": ("tent", dict(cfg=_tent_cfg(lr=1e-2, entropy_focus="uncertain", loss="entropy+consistency"),
                                   name="unet", model_kw=MK, state=unet3d_from_flax(_params(4)),
                                   batches=_batches([4], 4, label=False), n_valid=[4], mode="post",
                                   device_transform=DEVICE_TRANSFORM)),
        "tent_mid": ("tent", dict(cfg=_tent_cfg(lr=1e-2), name="unet_multimodal_midfusion",
                                  model_kw=dict(MID, remat=True), state=from_flax(pm),
                                  batches=_batches([2], 5, MID_SHAPE, label=False), n_valid=[2], mode="post",
                                  device_transform=BRATS, threshold=0.5)),
        "evaluate_tent": ("evaluate", dict(cfg=dict(_tent_cfg(episodic=False, lr=1e-2), **SURFACE), name="unet",
                                           model_kw=MK, state=unet3d_from_flax(_params(6)),
                                           batches=_batches([4, 3], 6), device_transform=DEVICE_TRANSFORM)),
        "stream": ("stream", dict(cfg=_tent_cfg(episodic=False, lr=1e-2), name="unet", model_kw=MK,
                                  state=unet3d_from_flax(_params(7)), batches=_batches([3, 1], 7, label=False),
                                  n_valid=[3, 1], device_transform=DEVICE_TRANSFORM)),
        "collectives": ("collectives", COLLECTIVES),
        "errors": ("errors", dict(cfg=_tent_cfg(), model_kw=MK, state=unet3d_from_flax(p1), shape=SHAPE)),
    }


_rng = np.random.RandomState(11)
COLLECTIVES = dict(x=_rng.randn(4, 3, 8, 4, 4).astype(np.float32), lo=1, hi=1,
                   w_halo=_rng.randn(SPACE, 4, 3, 6, 4, 4).astype(np.float32),
                   w_gather=_rng.randn(SPACE, 4, 3, 8, 4, 4).astype(np.float32))


def _phase23(root: str) -> dict:
    import chip_smoke

    return chip_smoke.space_parallel_phase("cpu", root, shape=(16, 32, 32), channels=(4, 8, 16, 32, 64),
                                           mid_shape=(16, 16, 16), mid_channels=(4, 8, 16, 32, 64), init_filters=4,
                                           threads=1)


class _Runs:
    """The spawn, then chip_smoke's phase 23 at fixture size, started at once
    in a thread, and the JAX references in threads of their own; ``[name]``
    waits for the spawn: ``(payload, [each rank's result], the one process's
    result)``."""

    def __init__(self, tmp: str):
        self.payloads = _payloads()
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.future = self.pool.submit(spawn, list(self.payloads.values()), f"{tmp}/ranks", DATA, SPACE, 300)
        self.phase23 = self.pool.submit(_phase23, f"{tmp}/phase23")
        # the JAX references, each in a thread (XLA compiles and runs without the GIL)
        self.jax_pool = concurrent.futures.ThreadPoolExecutor(3)
        self.jax = {"train": self.jax_pool.submit(_jax_train_ref, "train", 4, 2),
                    "train_mid": self.jax_pool.submit(_jax_train_ref, "train_mid", 2, 1),
                    "tent": self.jax_pool.submit(_jax_tent_ref)}

    def __getitem__(self, name):
        ranks, one = self.future.result()
        i = list(self.payloads).index(name)
        return self.payloads[name][1], [r[i] for r in ranks], one[i]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    (tmp / "ranks").mkdir()
    r = _Runs(str(tmp))
    yield r
    r.pool.shutdown()
    r.jax_pool.shutdown()


def _rel_l2(got: dict, want: dict, base: dict = None) -> float:
    ref = np.concatenate([(want[k] - (0 if base is None else base[k])).ravel() for k in want])
    apart = np.concatenate([(np.asarray(got[k]) - want[k]).ravel() for k in want])
    return float(np.linalg.norm(apart) / max(np.linalg.norm(ref), 1e-30))


def _same_on_every_rank(results, key):
    for r in results[1:]:
        for a, b in zip(r[key], results[0][key]):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{key}: {k} differs between the ranks")


# ---------------------------------------------------------------------------
# the split norm entries (no ranks)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(2, 8, 4, 4, 8), (1, 6, 3, 5, 3)])
def test_split_norm_entries_match_the_reference(runs, shape, relu):
    """The plain versions of stats / apply / bwd_sums / bwd_apply over a
    depth split in two slabs (their sums added, as the all-reduce does)
    against the reference norm on the whole volume and its ``jax.grad``; the
    CPU operators are the plain versions and launch nothing."""
    rng = np.random.RandomState(len(shape) + int(relu) + shape[-1])
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    gamma = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    beta = (rng.randn(shape[-1]) * 0.3).astype(np.float32)
    gy = rng.randn(*shape).astype(np.float32)
    act = "relu" if relu else None
    half = shape[1] // 2
    slabs = [torch.from_numpy(x[:, :half]).contiguous(), torch.from_numpy(x[:, half:]).contiguous()]
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    n = float(np.prod(shape[1:4]))
    launches = [f.launches for f in (fin.instance_norm_stats, fin.instance_norm_apply, fin.instance_norm_bwd_sums,
                                     fin.instance_norm_bwd_apply)]
    sums = sum(fin.instance_norm_stats(t) for t in slabs)
    np.testing.assert_allclose(sums, fin.instance_norm_stats_plain(torch.from_numpy(x)), rtol=1e-5, atol=1e-4)
    ys, stats = zip(*[fin.instance_norm_apply(t, g, b, sums, n=n, relu=relu) for t in slabs])
    want = np.asarray(instance_norm_reference(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), act=act))
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), want, rtol=1e-5, atol=1e-5)
    gsums = [fin.instance_norm_bwd_sums(torch.from_numpy(gy[:, sl]).contiguous(), t, g, b, st, relu=relu)
             for sl, t, st in zip((slice(0, half), slice(half, None)), slabs, stats)]
    total = gsums[0] + gsums[1]
    dx = torch.cat([fin.instance_norm_bwd_apply(torch.from_numpy(gy[:, sl]).contiguous(), t, g, b, st, total,
                                                n=n, relu=relu)
                    for sl, t, st in zip((slice(0, half), slice(half, None)), slabs, stats)], dim=1)

    def loss(xx, gg, bb):
        return (instance_norm_reference(xx, gg, bb, act=act) * gy).sum()

    jdx, jdg, jdb = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-4, atol=1e-5)
    # dgamma and dbeta: each slab's own sums, added over the slabs (the world's gradient sum)
    np.testing.assert_allclose(total[1].sum(0).numpy(), np.asarray(jdg), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(total[0].sum(0).numpy(), np.asarray(jdb), rtol=1e-4, atol=1e-4)
    assert launches == [f.launches for f in (fin.instance_norm_stats, fin.instance_norm_apply,
                                             fin.instance_norm_bwd_sums, fin.instance_norm_bwd_apply)]


def test_split_operators_pass_opcheck():
    """The four split operators' CPU implementations, fake implementations
    and schemas agree (``torch.library.opcheck``)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 4, 3, 3, 8).astype(np.float32))
    g, b = torch.rand(8) + 0.5, torch.randn(8) * 0.1
    sums = fin.instance_norm_stats(x)
    y, stats = fin.instance_norm_apply(x, g, b, sums, n=36.0)
    gy = torch.randn_like(x)
    for op, args in ((fin._stats_op, (x,)), (fin._apply_op, (x, g, b, sums, 36.0, 1e-5, True)),
                     (fin._bwd_sums_op, (gy, x, g, b, stats, True)),
                     (fin._bwd_apply_op, (gy, x, g, b, stats, sums, 36.0, True))):
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))


# ---------------------------------------------------------------------------
# against the JAX package (computed while the ranks run)


def _jax_train(payload, devices: int, data: int, module, params, steps: int = 1):
    jcfg = JaxConfigNode(payload["cfg"])
    mesh = jax_make_mesh(jax.devices()[:devices], data=data, space=devices // data)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx, lr = joptim.build_optimizer(jcfg.training, jparams)
    losses, moved = [], []
    with mesh:
        jt = JaxSegTrainer(jcfg, mesh=mesh, device_transform=payload["device_transform"])
        jt.setup(JaxTrainState.create(apply_fn=module.apply, params=jparams, tx=tx), None,
                 joptim.EpochScheduler(jcfg.training, lr))
        for batch in payload["batches"][:steps]:
            jt.run_step(batch)
            losses.append(jt.flush_step_metrics()["loss"])
            moved.append(jax.tree_util.tree_map(np.asarray, jt.state.params))
    return losses, moved


def _jax_train_ref(name: str, devices: int, data: int):
    payload = _payloads()[name][1]
    if name == "train":
        return _jax_train(payload, devices, data, JaxUNet3D(**MK), _params(1))
    return _jax_train(payload, devices, data, JaxMid(**MID, remat=True), _mid_params(2))


def _jax_tent_ref():
    """The JAX TentAdapter's continual inline step on the first batch of
    ``tent_inline`` over a ``data=1 x space=2`` mesh."""
    payload = _payloads()["tent_inline"][1]
    cfg = JaxConfigNode(payload["cfg"])
    mesh = jax_make_mesh(jax.devices()[:2], data=1, space=2)
    state = jax_state(_params(3), module=JaxUNet3D(**MK))
    with mesh:
        adapter = JaxTentAdapter(cfg.tta, config=cfg, mesh=mesh, device_transform=DEVICE_TRANSFORM)
        fn = adapter.make_adapt_predict_fn(state, threshold=0.3, predict_mode="inline")
        x, n = payload["batches"][0], payload["n_valid"][0]
        cur, pred = fn(state, jax_shard_batch({"image": x}, mesh)["image"], n)
        return (unet3d_from_flax(jax.tree_util.tree_map(np.asarray, cur.params)), [np.asarray(adapter._last_ents)],
                [np.asarray(pred)])


@pytest.mark.parametrize("name,devices,data", [("train", 4, 2), ("train_mid", 2, 1)],
                         ids=["flagship_2x2", "midfusion_1x2"])
def test_training_steps_match_the_reference_on_a_space_mesh(runs, name, devices, data):
    """The 2x2 ranks' first step against the JAX SegTrainer's on a data x
    space mesh of the CPU devices (the JAX end-to-end tests' bounds): the
    flagship on ``data=2 x space=2``, the mid-fusion UNet on ``data=1 x
    space=2``; the later steps are held to one process above."""
    losses, moved = runs.jax[name].result()
    payload, ranks, _ = runs[name]
    convert = unet3d_from_flax if name == "train" else from_flax
    np.testing.assert_allclose(ranks[0]["loss"][:len(losses)], losses, rtol=5e-4, atol=5e-5)
    source = {k: v.numpy() for k, v in payload["state"].items()}
    for i, jp in enumerate(moved):
        ref = {k: v.numpy() for k, v in convert(jp).items()}
        got = ranks[0]["params"][i]
        assert _rel_l2(got, {k: ref[k] for k in got}, source) <= 1e-3, f"params' moves after step {i}"


def test_tent_over_the_space_axis_matches_the_reference(runs):
    """The 2x2 ranks' continual inline Tent (2 steps on its first batch)
    against the JAX TentAdapter on a ``data=1 x space=2`` mesh (no random
    draws in this configuration)."""
    adapted, ents, preds = runs.jax["tent"].result()
    ranks = runs["tent_inline"][1]
    norm = [n for n, m in norm_param_mask(UNet3D(**MK, device="cpu")).items() if m]
    assert_adapted_close({k: torch.from_numpy(v) for k, v in ranks[0]["states"][0].items()}, adapted,
                         unet3d_from_flax(_params(3)), norm)
    for a, b in zip(ranks[0]["ents"], ents):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert_preds_close(ranks[0]["preds"][:1], preds)


# ---------------------------------------------------------------------------
# against one process


@pytest.mark.parametrize("name", ["train", "train_mid"])
def test_training_steps_equal_one_process(runs, name):
    """Each step over the 2x2 ranks (the flagship's second batch ragged: 3
    rows, the data rank 1 holding a padded row) equals the one-process step
    on the global batch: losses, the first step's gradients summed over the
    world (so gamma/beta and the whole bottleneck level count once), and the
    params; every rank holds the same params."""
    payload, ranks, one = runs[name]
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-5)
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)
    assert set(ranks[0]["grads"]) == set(one["grads"])
    assert _rel_l2(ranks[0]["grads"], one["grads"]) <= 1e-5
    for k in one["grads"]:  # every tensor on its own too: a doubled norm affine stands out
        assert _rel_l2({k: ranks[0]["grads"][k]}, {k: one["grads"][k]}) <= 1e-4, k
    for got, want in zip(ranks[0]["params"], one["params"]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-6, err_msg=k)
    _same_on_every_rank(ranks, "params")


@pytest.mark.parametrize("name", ["tent_inline", "tent_post", "tent_mid"])
def test_tent_over_the_space_axis_equals_one_process(runs, name):
    """Continual inline Tent (2 steps, a ragged batch), episodic strict Tent
    with the uncertain focus and a consistency term, and the mid-fusion
    UNet's strict step: entropies, adapted tensors, gate entropies and the
    gathered predictions equal one process's; every rank agrees."""
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


def test_evaluation_with_tent_equals_one_process(runs):
    """``TTAEngine.evaluate`` with continual Tent over the 2x2 ranks (a
    ragged batch; Dice, IoU, the loss, HD95, ASD, NSD on the depth-gathered
    volumes) returns on every rank the metrics of one process and leaves the
    model as it was."""
    _, ranks, one = runs["evaluate_tent"]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    assert set(ranks[0]["metrics"]) == set(one["metrics"]) and "avg_hd95" in one["metrics"]
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    for k, v in one["state"].items():
        np.testing.assert_array_equal(ranks[0]["state"][k], v, err_msg=k)


def test_stream_over_the_space_axis(runs):
    """The stream pads batches of 3 and 1 to the data axis, cuts each rank's
    slab and returns the global predictions, as one process does."""
    _, ranks, one = runs["stream"]
    np.testing.assert_allclose(ranks[0]["ents"], one["ents"], rtol=1e-5)
    for a, b in zip(ranks[0]["preds"], one["preds"]):
        assert a.shape == b.shape and (a == b).mean() >= 0.9999


def test_what_the_space_axis_refuses(runs):
    """The space axis refuses a slab thinner than 2 planes (a ValueError);
    everything else runs: the CNN classifiers (ResNet, DenseNet,
    EfficientNet) over a split image height since ROADMAP.md's item 12b-v-d
    (``tests/test_torch_space_classifiers.py``), UNETR, SwinUNETR, the
    sequence axis, the ViT classifier and a space axis beside a model,
    expert or stage axis (``tests/test_torch_space_transformers.py``,
    ``test_torch_sequence_axis.py``, ``test_torch_space_axes.py``), as do
    every conv segmenter, norm and training option
    (``tests/test_torch_space_models.py``) and every adapter, Tent's windows,
    the sliding window, flip TTA and the export
    (``tests/test_torch_space_adapters.py``)."""
    out = runs["errors"][1][0]
    runs_now = ("resnet18", "densenet121", "efficientnet_b0", "unetr", "swin_unetr", "sequence", "vit",
                "beside_model", "beside_expert", "beside_stage")
    assert set(out) == set(runs_now) | {"thin_slab"}
    assert all(out[key] is None for key in runs_now), out
    assert "ValueError" in out["thin_slab"] and "at least 2 planes" in out["thin_slab"]


# ---------------------------------------------------------------------------
# the collectives


def _window(x, s, lo, hi, n):
    pad = jnp.pad(x, ((0, 0), (0, 0), (lo, hi), (0, 0), (0, 0)))
    return pad[:, :, s * n: s * n + n + lo + hi]


def test_halo_exchange_and_gather_depth_match_jax_grad(runs):
    """``halo_exchange``'s slabs are the SAME-padded volume's windows and its
    gradient is ``jax.grad`` of the windows' weighted sum; ``gather_depth``
    gives every rank the volume and its gradient is the sum over the space
    ranks' weights; ``space_sum`` with its gradient sums both ways."""
    c, ranks = COLLECTIVES, runs["collectives"][1]
    x, lo, hi = c["x"], c["lo"], c["hi"]
    n, rows = x.shape[2] // SPACE, x.shape[0] // DATA

    def halo_loss(v):
        return sum((_window(v, s, lo, hi, n) * c["w_halo"][s]).sum() for s in range(SPACE))

    want_halo_grad = np.asarray(jax.grad(halo_loss)(jnp.asarray(x)))
    want_gather_grad = np.asarray(jax.grad(lambda v: sum((v * c["w_gather"][s]).sum()
                                                         for s in range(SPACE)))(jnp.asarray(x)))
    for r, got in enumerate(ranks):
        d, s = divmod(r, SPACE)
        sl = slice(d * rows, (d + 1) * rows)
        np.testing.assert_array_equal(got["halo"], np.asarray(_window(jnp.asarray(x), s, lo, hi, n))[sl])
        np.testing.assert_allclose(got["halo_grad"], want_halo_grad[sl, :, s * n:(s + 1) * n], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["gather"], x[sl])
        np.testing.assert_allclose(got["gather_grad"], want_gather_grad[sl, :, s * n:(s + 1) * n], rtol=1e-6,
                                   atol=1e-6)
        pair = [d * SPACE + k + 1 for k in range(SPACE)]  # the space group's values
        np.testing.assert_array_equal(got["space_sum"], np.full(2, float(sum(pair))))
        np.testing.assert_array_equal(got["space_sum_grad"], np.full(2, float(sum(range(1, SPACE + 1)))))


# ---------------------------------------------------------------------------
# chip_smoke's phase 23


def test_chip_smoke_space_parallel_phase_at_fixture_size(runs):
    """chip_smoke.py's phase 23 on the CPU at fixture size (run in the
    spawn's thread, after it): two spawned gloo ranks on a ``space=2`` mesh
    against one process on the same global batches (the flagship's
    training, validation, Tent online and strict, ``TTAEngine.evaluate``; a
    mid-fusion training step), within the phase's own limits; no kernel
    launches on the CPU; each rank's device store holds its depth slab."""
    import chip_smoke

    out = runs.phase23.result()
    c = out["compare"]
    assert out["backend"] == "gloo" and c["ranks"] == 2
    assert c["losses"]["max_rel"] <= chip_smoke.SP_LOSS_REL and c["val_max_abs"] <= chip_smoke.DP_METRIC_ABS
    assert c["grads"]["rel_l2"] <= chip_smoke.SP_GRAD_REL and c["mid"]["grad_rel_l2"] <= chip_smoke.SP_GRAD_REL
    assert all(v == 0 for r in out["ranks"] for part in r["launches"].values() for v in part.values())
    assert [r["tag"] for r in out["ranks"]] == ["rank0", "rank1"]
    assert all(r["store_shape"][1] == 8 for r in out["ranks"])
    # every split norm call of the f32 path went through the phase's check
    for r in out["ranks"]:
        kc = r["kernel_check"]
        assert kc["split_ok"] and set(kc["split"]) == {f"{k} float32" for k in chip_smoke.SplitCheck.OPS.values()}
        assert all(c["calls"] > 0 and c["max_abs_err"] == 0.0 for c in kc["split"].values())


def _bump(out):
    """A wrong kernel's result: every element off by a tenth of the
    output's scale."""
    if isinstance(out, tuple):
        return (_bump(out[0]),) + out[1:]
    return out + (0.1 * out.float().abs().max() + 0.1).to(out.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["_stats_op", "_apply_op", "_bwd_sums_op", "_bwd_apply_op"])
def test_chip_smoke_split_check_holds_each_entry(op, dtype, monkeypatch):
    """chip_smoke.py's ``SplitCheck`` (phase 23 holds every split norm call
    of the path to its plain version with it) on the CPU, through
    ``split_instance_norm``'s forward and backward: the plain versions pass
    it with no error; an entry whose result is off fails it, and only it."""
    import chip_smoke

    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 6, 5, 4, 8, generator=gen) * 2 + 0.5).to(dtype).requires_grad_()
    gamma = (torch.rand(8, generator=gen) + 0.5).requires_grad_()
    beta = (torch.randn(8, generator=gen) * 0.1).requires_grad_()
    gy = torch.randn(x.shape, generator=gen).to(dtype)
    name = str(dtype).replace("torch.", "")

    def run():
        with chip_smoke.SplitCheck() as check:
            y = fin.split_instance_norm(x, gamma, beta, n=float(6 * 5 * 4), reduce=lambda t: t)
            y.backward(gy)
        return check

    good = run()
    assert good.ok((name,)) and all(c["calls"] == 1 and c["max_abs_err"] == 0.0 for c in good.seen.values())
    wrong = getattr(fin, op)
    monkeypatch.setattr(fin, op, lambda *a: _bump(wrong(*a)))
    bad = run()
    key = f"{chip_smoke.SplitCheck.OPS[op]} {name}"
    assert not bad.ok((name,)) and bad.seen[key]["worst"] > 1.0
    assert all(c["worst"] <= 1.0 for k, c in bad.seen.items() if k != key)
