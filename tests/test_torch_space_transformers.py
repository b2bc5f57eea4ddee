"""UNETR and SwinUNETR over the space axis (``models/unetr.py``,
``models/swin_unetr.py``, ``parallel/space.py:roll_depth``): four gloo ranks
on the CPU on a ``data=2 x space=2`` mesh against the one-process port on
the same global batches, and against the JAX package on a ``data=1 x
space=2`` mesh of its CPU devices.

One spawn (``tests/_torch_st_worker.py``, which imports no JAX) runs every
rank case and the same case functions in one more process without a mesh,
while the JAX references run in threads here. Each fixture keeps at least
one level split and one whole over the two space ranks
(``test_fixture_levels``):

  * UNETR A (patch 8 on [16, 16, 16]): every slab holds whole patches and
    embeds them itself; the conv levels 16, 8 and 4 split, the token grid
    (2 planes) is whole;
  * UNETR B (patch 8 on [24, 16, 16], with a MoE block): a 12-plane slab
    holds 1.5 patches, so the embed takes the gathered input; levels 24, 12
    and 6 split, the 3-plane grid whole, and the encoder's MoE runs whole;
  * SwinUNETR A (window 2 on [16, 16, 16]): stages 0 and 1 split, their
    shifted blocks rolling the depth across the ranks, stage 2 whole;
  * SwinUNETR B (window (4, 2, 2) on [40, 32, 32]): no stage split (a slab
    of 10 and of 5 planes holds no whole window of depth 4) on split conv
    levels, an odd stage (5 planes) whose ``dec_up`` output is cropped
    before each rank takes its slab.

A voxel whose pre-activation lies within f32 rounding of a ReLU's kink
flips its mask between any two summation orders, one process's batch of 2
against its batches of 1 too, and moves a gradient by its whole term (a
SwinUNETR B on [24, 32, 32] moves one process's own gradients by 1.5e-3
so). SwinUNETR B's training step is held to twice such a witness computed
here: one process's first-step gradients on the batch of 4 against the sum
of its four batches of 1 (9.7e-5 at this fixture); the other fixtures to
1e-5.

Tolerances (``tests/test_torch_space_models.py``'s): ranks vs one process
(f32): losses and entropies within 1e-5 relative; the first step's
gradients summed over the ranks within 1e-5 relative L2; params within
1e-5 relative plus 2e-6; predictions equal on >= 99.99% of voxels; metrics
within 1e-6. Against the JAX package: losses within 5e-4 relative plus
5e-5, the params' moves within 1e-3 relative L2.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core import optim as joptim
from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
from multimodal_tta_tpu.core.trainers.seg_trainer import SegTrainer as JaxSegTrainer
from multimodal_tta_tpu.models.swin_unetr import SwinUNETR as JaxSwin
from multimodal_tta_tpu.models.unetr import UNETR as JaxUNETR
from multimodal_tta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_tta_tpu_torch.models.convert import from_flax
from multimodal_tta_tpu_torch.parallel import space as sp
from multimodal_tta_tpu_torch.registry import get_model

from _torch_port import DEVICE_TRANSFORM, SGD, random_flax_params, trainer_config, tta_config
from _torch_st_worker import spawn, train_case

UNETR_A = dict(in_channels=2, num_classes=1, patch_size=8, hidden_size=16, mlp_dim=32, num_heads=2, num_layers=3,
               feature_size=4)
UNETR_B = dict(UNETR_A, moe_experts=2, moe_every=2)
SWIN_A = dict(in_channels=2, num_classes=1, feature_size=6, depths=(2, 2, 2), num_heads=(1, 2, 2), window_size=2)
SWIN_B = dict(SWIN_A, window_size=(4, 2, 2))
# name -> (flax class, port registry name, kwargs, volume [D, H, W, C], flax seed)
MODELS = {"unetr_a": (JaxUNETR, "unetr", UNETR_A, (16, 16, 16, 2), 41),
          "unetr_b": (JaxUNETR, "unetr", UNETR_B, (24, 16, 16, 2), 42),
          "swin_a": (JaxSwin, "swin_unetr", SWIN_A, (16, 16, 16, 2), 43),
          "swin_b": (JaxSwin, "swin_unetr", SWIN_B, (40, 32, 32, 2), 44)}
SURFACE = {"seg": {"region_order": ["GTV"], "threshold": 0.3, "spacing": [1.0, 1.0, 1.0]},
           "surface": {"enable": True, "nsd_tol": 1.0}, "loss": {"report_loss": True}}
FLIP = {"enable": True, "axes": [1, 2, 3]}
KNOBS = {  # tests/test_torch_space_adapters.py's
    "pl": dict(steps=2, lr=1e-2, pl={"conf_threshold": 0.6}),
    "eata": dict(steps=2, lr=1e-2, entropy_focus="uncertain", reliability={"margin_ratio": 1.0},
                 fisher={"batches": 1, "lambda": 50.0}),
    "sar": dict(steps=2, lr=0.2, rho=0.5, margin_ratio=1.0),
    "cotta": dict(steps=2, lr=1e-2, ema=0.9, n_views=2, restore={"enabled": True, "prob": 0.2}),
    "memo": dict(steps=1, lr=1e-2, n_views=3, serve="marginal", restore={"enabled": True, "prob": 0.2}),
}
ADAPTERS = {"unetr_a_pl": "pl", "swin_a_eata": "eata", "unetr_a_sar": "sar", "swin_a_cotta": "cotta",
            "unetr_a_memo": "memo"}
TRAIN = [f"{m}_train" for m in MODELS]
TENT = ["unetr_a_tent", "swin_a_tent"]
EVAL = ["unetr_a_eval_flip", "swin_a_eval_flip", "unetr_a_eval_sliding", "swin_a_eval_sliding"]
JAX_TRAIN = ["unetr_a", "swin_a"]


def _kw(model: str) -> dict:
    """The port's kwargs: the flax ones and ``image_size``."""
    _, _, kw, shape, _ = MODELS[model]
    return dict(kw, image_size=shape[:3])


def _flax(model: str):
    module, _, kw, shape, seed = MODELS[model]
    return random_flax_params(module(**kw), (1,) + shape, seed)


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


def _eval_cfg(tta: dict, **evaluation) -> dict:
    cfg = _tent_cfg(**tta)
    cfg["evaluation"] = dict(SURFACE, **evaluation)
    return cfg


def _train_cfg(model: str) -> dict:
    _, _, kw, _, _ = MODELS[model]
    return trainer_config(SGD, model={k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()})


def _payloads() -> dict:
    states = {m: from_flax(_flax(m)) for m in MODELS}
    out = {}
    for m, (_, name, kw, shape, seed) in MODELS.items():
        # a batch statistic (the MoE load balance) pools the padded rows over
        # the ranks, as in the reference: its fixture's batches are not ragged
        sizes = [4, 4] if kw.get("moe_experts") else [4, 3]
        out[f"{m}_train"] = ("train", dict(cfg=_train_cfg(m), name=name, model_kw=_kw(m), state=states[m],
                                           batches=_batches(sizes, seed, shape), device_transform=DEVICE_TRANSFORM))
    a = dict(model_kw=None, device_transform=DEVICE_TRANSFORM)
    for m in ("unetr_a", "swin_a"):
        name, shape = MODELS[m][1], MODELS[m][3]
        base = dict(a, name=name, model_kw=_kw(m), state=states[m])
        out[f"{m}_tent"] = ("tent", dict(base, cfg=_tent_cfg(episodic=m == "swin_a", steps=2, lr=1e-2),
                                         batches=_batches([4, 4], 50, shape, label=False), n_valid=[4, 3],
                                         mode="post" if m == "swin_a" else "inline"))
        out[f"{m}_eval_flip"] = ("evaluate", dict(base, cfg=_eval_cfg(dict(episodic=False, lr=1e-2), flip_tta=FLIP),
                                                  batches=_batches([4, 3], 51, shape)))
        # windows of the built size (its patch count, its stages' windows) on a
        # volume twice as deep: three windows, each split over the ranks
        out[f"{m}_eval_sliding"] = ("evaluate", dict(base, cfg=_eval_cfg(dict(method="none"), sliding_window={
            "enable": True, "roi_size": list(shape[:3]), "overlap": 0.5}),
            batches=_batches([2], 52, (2 * shape[0],) + shape[1:])))
    for key, method in ADAPTERS.items():
        m = key.rsplit("_", 1)[0]
        out[key] = ("adapter", dict(a, cfg=_tent_cfg(method=method, episodic=False, **KNOBS[method]),
                                    name=MODELS[m][1], model_kw=_kw(m), state=states[m],
                                    batches=_batches([4, 4], 53, MODELS[m][3], label=False), n_valid=[4, 3]))
    out["swin_a_export"] = ("probs", dict(cfg=_eval_cfg(dict(method="none"), flip_tta=FLIP), name="swin_unetr",
                                          model_kw=_kw("swin_a"), state=states["swin_a"],
                                          image=_batches([2], 54, MODELS["swin_a"][3], label=False)[0]))
    return {k: (case, "d2s2", payload) for k, (case, payload) in out.items()}


WITNESSED = ("swin_b_train",)


def _witness(payload: dict) -> float:
    """How far one process's first-step gradients move when only its sums'
    order changes: the batch against the sum of its rows' steps (each row's
    loss over the batch's count)."""
    batch = payload["batches"][0]
    n = batch["image"].shape[0]
    whole = train_case(None, **dict(payload, batches=[batch]))["grads"]
    rows = [train_case(None, **dict(payload, batches=[{k: v[i:i + 1] for k, v in batch.items()}]))["grads"]
            for i in range(n)]
    return _rel_l2({k: sum(r[k] for r in rows) / n for k in whole}, whole)


def _jax_train(model: str, payload: dict):
    """The JAX SegTrainer's first step on a ``data=1 x space=2`` mesh of the
    CPU devices: its loss and params."""
    module, _, kw, _, _ = MODELS[model]
    jcfg = JaxConfigNode(payload["cfg"])
    mesh = jax_make_mesh(jax.devices()[:2], data=1, space=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, _flax(model))
    tx, lr = joptim.build_optimizer(jcfg.training, jparams)
    with mesh:
        jt = JaxSegTrainer(jcfg, mesh=mesh, device_transform=payload["device_transform"])
        jt.setup(JaxTrainState.create(apply_fn=module(**kw).apply, params=jparams, tx=tx), None,
                 joptim.EpochScheduler(jcfg.training, lr))
        jt.run_step(payload["batches"][0])
        return jt.flush_step_metrics()["loss"], jax.tree_util.tree_map(np.asarray, jt.state.params)


def _phase(root: str) -> dict:
    """chip_smoke.py's transformers job at fixture size: two spawned gloo
    ranks on a ``space=2`` mesh against one process."""
    import chip_smoke

    return chip_smoke.space_transformers_phase(
        "cpu", root, shape=(16, 16, 16), brats_shape=(32, 16, 16), threads=1,
        unetr=dict(patch_size=8, hidden_size=16, mlp_dim=32, num_heads=2, num_layers=3, feature_size=4),
        swin=dict(feature_size=6, depths=[2, 2], num_heads=[1, 2], window_size=2))


class _Runs:
    """The spawn in a thread and the JAX references in threads of their
    own; ``[name]`` waits for the spawn: ``(payload, [each rank's result],
    the one process's result)``."""

    def __init__(self, tmp: str):
        self.payloads = _payloads()
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.future = self.pool.submit(spawn, list(self.payloads.values()), tmp, 400)
        self.phase = self.pool.submit(_phase, f"{tmp}/phase")
        self.jax_pool = concurrent.futures.ThreadPoolExecutor(2)
        self.jax = {m: self.jax_pool.submit(_jax_train, m, self.payloads[f"{m}_train"][2]) for m in JAX_TRAIN}
        self.witness = {n: self.jax_pool.submit(_witness, self.payloads[n][2]) for n in WITNESSED}

    def __getitem__(self, name):
        ranks, one = self.future.result()
        i = list(self.payloads).index(name)
        return self.payloads[name][2], [r[i] for r in ranks], one[i]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(str(tmp_path_factory.mktemp("st")))
    yield r
    r.pool.shutdown()
    r.jax_pool.shutdown()


def _rel_l2(got: dict, want: dict, base: dict = None) -> float:
    ref = np.concatenate([(want[k] - (0 if base is None else base[k])).ravel() for k in want])
    apart = np.concatenate([(np.asarray(got[k]) - want[k]).ravel() for k in want])
    return float(np.linalg.norm(apart) / max(np.linalg.norm(ref), 1e-30))


def _close_states(got: dict, want: dict):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=2e-6, err_msg=k)


def _same(ranks, key):
    for r in ranks[1:]:
        for k, v in ranks[0][key].items():
            np.testing.assert_array_equal(r[key][k], v, err_msg=f"{key}: {k} differs between the ranks")


# ---------------------------------------------------------------------------


class _Axis:
    size = 2


@pytest.mark.parametrize("model,levels,stages", [
    ("unetr_a", [True, True, True, False], None), ("unetr_b", [True, True, True, False], None),
    ("swin_a", [True, True, True, False, False], [True, True, False]),
    ("swin_b", [True, True, True, False, False], [False, False, False])])
def test_fixture_levels(model, levels, stages):
    """Each fixture's conv levels over two space ranks, and SwinUNETR's
    stages (split only where the slab holds whole windows): at least one
    split and one whole, and the ones the cases rest on."""
    _, name, _, shape, _ = MODELS[model]
    depth = shape[0] // _Axis.size
    if name == "unetr":
        got = [a is not None for a in sp.level_axes(_Axis(), depth, (2,) * 3)]
        assert (depth % UNETR_A["patch_size"] == 0) == (model == "unetr_a")  # A embeds locally, B gathers
    else:
        m = get_model(name)(**_kw(model), device="cpu", seed=None)
        axes, stage_axes = m.stage_axes(_Axis(), depth)
        got = [a is not None for a in axes]
        assert [a is not None for a in stage_axes] == stages
    assert got == levels


@pytest.mark.parametrize("name", TRAIN)
def test_training_equals_one_process(runs, name):
    """Two SGD steps over the 2x2 ranks (the second batch of 3 rows ragged,
    but UNETR B's: its MoE load balance pools the padded rows) equal one
    process's on the global batch: losses, the first step's
    gradients summed over the world, the params after each step and UNETR
    B's MoE scalars; every rank holds the same params. SwinUNETR B's
    gradients and moves are held to twice one process's own distance under
    a reordering of its sums (``_witness``)."""
    payload, ranks, one = runs[name]
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-5)
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)
    assert set(ranks[0]["grads"]) == set(one["grads"])
    if name in WITNESSED:
        bound = max(1e-5, 2.0 * runs.witness[name].result())
        source = {k: v.numpy() for k, v in payload["state"].items()}
        for got, want in zip(ranks[0]["params"], one["params"]):
            assert _rel_l2(got, want, source) <= bound
    else:
        bound = 1e-5
        for got, want in zip(ranks[0]["params"], one["params"]):
            _close_states(got, want)
    assert _rel_l2(ranks[0]["grads"], one["grads"]) <= bound
    for r in ranks[1:]:
        for a, b in zip(r["params"], ranks[0]["params"]):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(ranks[0]["moe"]) == len(one["moe"]) == (2 if name == "unetr_b_train" else 0)
    for got, want in zip(ranks[0]["moe"], one["moe"]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", TENT)
def test_tent_equals_one_process(runs, name):
    """Continual inline Tent on UNETR and episodic strict Tent on SwinUNETR
    (2 steps a batch, the second ragged): entropies, adapted tensors, gate
    entropies and the gathered predictions equal one process's; every rank
    agrees."""
    _, ranks, one = runs[name]
    for a, b in zip(ranks[0]["ents"], one["ents"]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for r in ranks[1:]:
        for a, b in zip(r["ents"], ranks[0]["ents"]):
            np.testing.assert_array_equal(a, b)
    _same(ranks, "state")
    _close_states(ranks[0]["state"], one["state"])
    np.testing.assert_allclose(ranks[0]["gate"], one["gate"], rtol=1e-5)
    for a, b in zip(ranks[0]["preds"], one["preds"]):
        assert a.shape == b.shape and (a == b).mean() >= 0.9999


@pytest.mark.parametrize("name", list(ADAPTERS))
def test_adapters_equal_one_process(runs, name):
    """pl, sar and memo on UNETR, eata and cotta on SwinUNETR, continual
    strict over two batches (the second ragged; the draws the global
    batch's): each batch's entropies, adapted tensors, CoTTA's teacher and
    the gathered predictions equal one process's; every rank agrees."""
    _, ranks, one = runs[name]
    r0 = ranks[0]
    for a, b in zip(r0["ents"], one["ents"]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for got, want in zip(r0["states"], one["states"]):
        _close_states(got, want)
    for got, want in zip(r0["teacher"], one["teacher"]):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6)
    assert r0["resets"] == one["resets"] and r0["names"] == one["names"]
    for a, b in zip(r0["preds"], one["preds"]):
        assert a.shape == b.shape and (a == b).mean() >= 0.9999
    for r in ranks[1:]:
        for a, b in zip(r["ents"], r0["ents"]):
            np.testing.assert_array_equal(a, b)
        for k, v in r0["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


@pytest.mark.parametrize("name", EVAL)
def test_evaluation_equals_one_process(runs, name):
    """``TTAEngine.evaluate`` over the 2x2 ranks with flip TTA on axes 1,
    2, 3 after a continual Tent step (a ragged batch), and with the sliding
    window (windows of the built size, each split): every rank returns one
    process's metrics (HD95, ASD and NSD on the depth-gathered volumes) and
    leaves the model as it was."""
    _, ranks, one = runs[name]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    assert set(ranks[0]["metrics"]) == set(one["metrics"]) and "avg_hd95" in one["metrics"]
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    for k, v in one["state"].items():
        np.testing.assert_array_equal(ranks[0]["state"][k], v, err_msg=k)


def test_export_forward_equals_one_process(runs):
    """The forward that evaluation and the export score (flip TTA on axes
    1, 2, 3, the mirror-ensemble variance) on SwinUNETR over the 2x2 ranks:
    the gathered logits, probabilities and variance equal one process's."""
    _, ranks, one = runs["swin_a_export"]
    for r in ranks:
        for k in ("logits", "prob", "var"):
            assert np.abs(r[k] - one[k]).max() <= 1e-5 * max(1.0, float(np.abs(one[k]).max())), k
    assert float(one["var"].max()) > 0.0


@pytest.mark.parametrize("model", JAX_TRAIN)
def test_transformers_match_the_reference_on_a_space_mesh(runs, model):
    """The 2x2 ranks' first step of UNETR and SwinUNETR against the JAX
    SegTrainer's on a ``data=1 x space=2`` mesh of the CPU devices (the JAX
    end-to-end bounds)."""
    loss, params = runs.jax[model].result()
    payload, ranks, _ = runs[f"{model}_train"]
    np.testing.assert_allclose(ranks[0]["loss"][0], loss, rtol=5e-4, atol=5e-5)
    source = {k: v.numpy() for k, v in payload["state"].items()}
    ref = {k: v.numpy() for k, v in from_flax(params).items()}
    got = ranks[0]["params"][0]
    assert _rel_l2(got, {k: ref[k] for k in got}, source) <= 1e-3


def test_chip_smoke_space_transformers_at_fixture_size(runs):
    """chip_smoke.py's transformers job of phase 23 (``st_run``) on the CPU
    at fixture size: two spawned gloo ranks on a ``space=2`` mesh against
    one process (UNETR and SwinUNETR: a forward, an SGD step, a Tent step,
    an evaluated batch; UNETR with the sequence axis: a forward and an SGD
    step), within the job's own limits; every split norm call went through
    its check; no kernel launches on the CPU."""
    import chip_smoke

    out = runs.phase.result()
    c = out["compare"]
    assert c["ranks"] == 2 and set(c["cases"]) == set(out["cases"]) == set(chip_smoke.ST_CASES)
    for name, case in c["cases"].items():
        assert case["logits_rel_l2"] <= chip_smoke.ST_LOGIT_REL and case["loss_rel"] <= chip_smoke.SP_LOSS_REL
        assert case["grad_rel_l2"] <= chip_smoke.SP_GRAD_REL, (name, case)
        if "tent" in case:
            assert case["tent"]["pred_agree"] >= chip_smoke.SP_PRED_AGREE, (name, case)
    assert all(v == 0 for v in out["launches"].values())
    for r in out["ranks"]:
        assert {"stats float32", "apply float32", "bwd_sums float32", "bwd_apply float32"} <= set(r["check"]["split"])
        assert all(v["calls"] > 0 and v["max_abs_err"] == 0.0 for v in r["check"]["split"].values())
        assert r["norms"]["swin_unetr"]["whole"] > 0 and r["norms"]["swin_unetr"]["split"] > 0
