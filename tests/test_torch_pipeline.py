"""The stage axis over ranks (``multimodal_tta_tpu_torch/parallel/pipeline.py``,
GPipe): four gloo ranks on the CPU on ``data=2 x stage=2`` and ``data=1 x
stage=4`` meshes against the sequential layer stack in one process and
against the JAX package's ``parallel/pipeline.py`` on ``make_mesh`` of its
CPU devices, with ``tests/test_pipeline.py``'s cases and tolerances:

  - the forward (``pipeline_apply``, ``vit_forward_pipelined``) within
    2e-5 relative plus 2e-6 (ViT: 2e-5) absolute;
  - the loss within 1e-5 relative and the stacked gradients within 2e-5
    relative plus 2e-6 absolute (``pipeline_value_and_grad``, with and
    without remat);
  - three SGD steps with momentum of ``make_pipeline_train_step`` within
    2e-4 relative plus 2e-5 absolute of the sequential steps, the loss
    falling;
  - the pipelined ViT's gradients within 5e-4 relative plus 5e-5 absolute.

One spawn (``tests/_torch_pp_worker.py``, which imports no JAX) runs every
four-rank case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_tta_tpu.models.vit import ViT as JaxViT
from multimodal_tta_tpu.parallel import pipeline as jpipe
from multimodal_tta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_tta_tpu_torch.models.convert import from_flax
from multimodal_tta_tpu_torch.models.vit import ViT
from multimodal_tta_tpu_torch.parallel import mesh as pmesh
from multimodal_tta_tpu_torch.parallel import pipeline

from _torch_port import SMALL, SGD, random_flax_params, trainer_config, tta_config
from _torch_pp_worker import CASES, layer_fn, spawn

torch.set_num_threads(2)

N_LAYERS, DIM = 8, 16
LAYERS = {f"layer{i}": {"w": (np.random.RandomState(i).randn(DIM, DIM) * 0.1).astype(np.float32),
                        "b": (np.random.RandomState(50 + i).randn(DIM) * 0.01).astype(np.float32)}
          for i in range(N_LAYERS)}
X3 = np.random.RandomState(2).randn(8, 6, DIM).astype(np.float32)
X2 = np.random.RandomState(3).randn(8, DIM).astype(np.float32)
TGT = np.random.RandomState(4).randn(8, DIM).astype(np.float32)
# tests/test_pipeline.py:145: the tiny ViT (depth 4) on [8, 8, 8, 3]
TINY_VIT = dict(variant="vit_b_16", num_classes=5, image_size=8, patch=4, hidden=32, depth=4, heads=4, mlp_dim=64)
VIT_PARAMS = random_flax_params(JaxViT(**TINY_VIT), (1, 8, 8, 3), 6)
VIT_X = np.random.RandomState(7).randn(8, 8, 8, 3).astype(np.float32)
LABELS = np.array([0, 1, 2, 3, 4, 0, 1, 2])
MESHES = {"d2s2": dict(data=2, stage=2), "d1s4": dict(data=1, stage=4)}
PHASE27 = dict(batch=8, side=32, threads=1, model=dict(patch=16, hidden=32, depth=4, heads=4, mlp_dim=64,
                                                       num_classes=10))
SEG_BATCHES = [{"image": np.random.RandomState(20 + i).randn(4, 8, 16, 16, 2).astype(np.float32),
                "label": (np.random.RandomState(30 + i).rand(4, 8, 16, 16, 1) > 0.7).astype(np.float32)}
               for i in range(2)]
SURFACE = {"seg": {"region_order": ["GTV"], "threshold": 0.3, "spacing": [1.0, 1.0, 1.0]}}
REPLICA = dict(cfg=trainer_config(SGD), eval_cfg=dict(tta_config(lr=1e-2, episodic=False), evaluation=SURFACE),
               model_kw=SMALL, batches=SEG_BATCHES)


def _payloads():
    base = dict(layers=LAYERS, n_layers=N_LAYERS)
    return {
        "apply_d2s2_m4": ("apply", "d2s2", dict(base, x=X3, n_micro=4)),
        "apply_d2s2_m2": ("apply", "d2s2", dict(base, x=X3, n_micro=2)),
        "apply_d1s4_m4": ("apply", "d1s4", dict(base, x=X3, n_micro=4)),
        "grad_d2s2": ("grad", "d2s2", dict(base, x=X2, target=TGT, n_micro=4, remat=False)),
        "grad_d2s2_remat": ("grad", "d2s2", dict(base, x=X2, target=TGT, n_micro=4, remat=True)),
        "grad_d1s4_remat": ("grad", "d1s4", dict(base, x=X2, target=TGT, n_micro=4, remat=True)),
        "train": ("train", "d2s2", dict(base, x=X2, target=TGT, n_micro=4, steps=3, lr=0.1, momentum=0.9)),
        "vit_d2s2": ("vit", "d2s2", dict(kw=dict(TINY_VIT, in_channels=3), params=VIT_PARAMS, x=VIT_X,
                                         labels=LABELS, n_micro=4)),
        "vit_d1s4": ("vit", "d1s4", dict(kw=dict(TINY_VIT, in_channels=3), params=VIT_PARAMS, x=VIT_X,
                                         labels=LABELS, n_micro=4)),
        "replica": ("replica", "d2s2", REPLICA),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every four-rank case in one spawn: ``{name: (payload, [each rank's result])}``."""
    import chip_smoke

    tmp = str(tmp_path_factory.mktemp("pp"))
    payloads = _payloads()
    phase = chip_smoke.stage_axis_prepare("cpu", f"{tmp}/phase27", **PHASE27)
    ranks = spawn(list(payloads.values()), tmp, world=4, timeout=300, axes_jobs=[("stage_axis", phase["spec"])])
    out = {name: (payload, [r[i] for r in ranks]) for i, (name, (_, _, payload)) in enumerate(payloads.items())}
    out["phase27"] = (phase, None)
    return out


def _sequential(x: np.ndarray) -> torch.Tensor:
    h = torch.from_numpy(x)
    for i in range(N_LAYERS):
        h = layer_fn({k: torch.from_numpy(v) for k, v in LAYERS[f"layer{i}"].items()}, h)
    return h


def _jax_stacked():
    return jpipe.stack_layer_params(jax.tree_util.tree_map(jnp.asarray, LAYERS), "layer", N_LAYERS)


def _jax_layer(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


def _stage_mesh(**sizes):
    """A mesh of the given sizes seen from rank 0, with no process group
    (what the checks read before any collective)."""
    m = pmesh.Mesh.__new__(pmesh.Mesh)
    m.rank, m.data, m.space = 0, sizes.get("data", 1), 1
    m.stage = sizes.get("stage", 1)
    return m


# ---------------------------------------------------------------------------
# stacking and the reference's checks


def test_stack_layer_params_matches_the_reference():
    """``tests/test_pipeline.py:71-83``: the layers stacked in order, the same
    arrays as the reference's; a flat state dict stacks alike; a missing
    layer raises ``KeyError`` naming it."""
    got = pipeline.stack_layer_params(LAYERS, "layer", 3)
    want = jpipe.stack_layer_params(LAYERS, "layer", 3)
    assert set(got) == set(want) and got["w"].shape == (3, DIM, DIM)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    flat = {f"{k}.{n}": torch.from_numpy(v) for k, d in LAYERS.items() for n, v in d.items()}
    assert all(torch.equal(a, got[k]) for k, a in pipeline.stack_layer_params(flat, "layer", 3).items())
    with pytest.raises(KeyError, match="layer8"):
        pipeline.stack_layer_params(LAYERS, "layer", 9)


@pytest.mark.parametrize("sizes,n_layers,batch,n_micro,message", [
    ({"data": 1}, 2, 4, 2, "stage axis"), ({"data": 2, "stage": 4}, 6, 4, 2, "not divisible"),
    ({"data": 2, "stage": 4}, 4, 6, 4, "n_micro"), ({"data": 2, "stage": 2}, 4, 6, 2, "data axis extent")])
def test_checks_raise_as_the_reference(sizes, n_layers, batch, n_micro, message):
    """``tests/test_pipeline.py:122-141``: no stage axis, a layer count that
    does not split over the stages, a batch that does not split into
    microbatches, and a microbatch that does not split over the data axis
    raise ``ValueError`` with the reference's message."""
    stacked = pipeline.stack_layer_params({f"layer{i}": LAYERS[f"layer{i}"] for i in range(n_layers)}, "layer",
                                          n_layers)
    x = torch.zeros(batch, DIM)
    jmesh = jax_make_mesh(jax.devices()[:int(np.prod(list(sizes.values())))], **sizes)
    with pytest.raises(ValueError, match=message) as want:
        jpipe.pipeline_apply(jmesh, _jax_layer, jax.tree_util.tree_map(jnp.asarray, dict(stacked)), jnp.zeros((batch, DIM)),
                             n_micro=n_micro)
    with pytest.raises(ValueError) as got:
        pipeline.pipeline_apply(_stage_mesh(**sizes), layer_fn, stacked, x, n_micro=n_micro)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the forward


@pytest.mark.parametrize("name", ["apply_d2s2_m4", "apply_d2s2_m2", "apply_d1s4_m4"])
def test_pipeline_apply_matches_sequential(runs, name):
    """``tests/test_pipeline.py:90``: the pipelined stack equals the
    sequential one and the reference's pipeline on the same mesh, on every
    rank; each stage but the last sends one hop a microbatch (the
    reference's check that the program really hops)."""
    payload, ranks = runs[name]
    ref = _sequential(payload["x"]).numpy()
    sizes = MESHES[name.split("_")[1]]
    jm = jax_make_mesh(jax.devices()[:4], **sizes)
    with jm:
        jref = np.asarray(jax.jit(lambda p, x: jpipe.pipeline_apply(jm, _jax_layer, p, x, n_micro=payload["n_micro"]))(
            _jax_stacked(), jnp.asarray(payload["x"])))
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["y"], ref, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(res["y"], jref, rtol=2e-5, atol=2e-6)
        last = r % sizes["stage"] == sizes["stage"] - 1
        assert res["sends"] == (0 if last else payload["n_micro"])


@pytest.mark.parametrize("name", ["vit_d2s2", "vit_d1s4"])
def test_vit_forward_pipelined_matches_sequential(runs, name):
    """``tests/test_pipeline.py:145``, ``:163``: the pipelined ViT's CLS
    features and logits equal the sequential model's and the reference's
    ``vit_forward_pipelined`` on the same mesh."""
    payload, ranks = runs[name]
    model = ViT(**payload["kw"], device="cpu")
    model.load_state_dict(from_flax(VIT_PARAMS), strict=True)
    with torch.no_grad():
        cls, logits = model(torch.from_numpy(VIT_X))
    jvit = JaxViT(**TINY_VIT)
    jm = jax_make_mesh(jax.devices()[:4], **MESHES[name.split("_")[1]])
    with jm:
        jcls, jlogits = jax.jit(lambda v, x: jpipe.vit_forward_pipelined(jvit, v, x, jm, n_micro=4))(
            {"params": VIT_PARAMS}, jnp.asarray(VIT_X))
    for res in ranks:
        for got, want, jwant in ((res["cls"], cls, jcls), (res["logits"], logits, jlogits)):
            np.testing.assert_allclose(got, want.numpy(), rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(got, np.asarray(jwant), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the backward and training


@pytest.mark.parametrize("name", ["grad_d2s2", "grad_d2s2_remat", "grad_d1s4_remat"])
def test_grad_matches_sequential(runs, name):
    """``tests/test_pipeline.py:202``: the GPipe backward's loss and stacked
    gradients equal the sequential stack's (``torch.autograd``) and the
    reference's ``pipeline_value_and_grad`` on the same mesh, with and
    without remat, on every rank."""
    payload, ranks = runs[name]
    stacked = {k: v.clone().requires_grad_() for k, v in pipeline.stack_layer_params(LAYERS, "layer", N_LAYERS).items()}
    h = torch.from_numpy(X2)
    for i in range(N_LAYERS):
        h = layer_fn({k: v[i] for k, v in stacked.items()}, h)
    loss = ((h - torch.from_numpy(TGT)) ** 2).mean()
    loss.backward()
    jm = jax_make_mesh(jax.devices()[:4], **MESHES[name.split("_")[1]])
    with jm:
        jloss, jgrad = jax.jit(lambda p, x: jpipe.pipeline_value_and_grad(
            jm, _jax_layer, p, x, lambda y: jnp.mean((y - TGT) ** 2), n_micro=4, remat=payload["remat"]))(
            _jax_stacked(), jnp.asarray(X2))
    for res in ranks:
        np.testing.assert_allclose(res["loss"], loss.item(), rtol=1e-5)
        np.testing.assert_allclose(res["loss"], float(jloss), rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(res["grads"][k], stacked[k].grad.numpy(), rtol=2e-5, atol=2e-6)
            np.testing.assert_allclose(res["grads"][k], np.asarray(jgrad[k]), rtol=2e-5, atol=2e-6)


def test_train_step_matches_sequential_sgd(runs):
    """``tests/test_pipeline.py:245``: three GPipe steps of SGD with
    momentum, each stage updating its own 4 of the 8 layers, equal three
    sequential full-batch steps (torch's SGD and the reference's optax
    chain); the loss falls."""
    _, ranks = runs["train"]
    stacked = {k: v.clone().requires_grad_() for k, v in pipeline.stack_layer_params(LAYERS, "layer", N_LAYERS).items()}
    opt = torch.optim.SGD(list(stacked.values()), lr=0.1, momentum=0.9)
    jparams, jopt = _jax_stacked(), optax.sgd(0.1, momentum=0.9)
    jstate = jopt.init(jparams)

    def jloss(p):
        h = jnp.asarray(X2)
        for i in range(N_LAYERS):
            h = _jax_layer(jax.tree_util.tree_map(lambda a: a[i], p), h)
        return jnp.mean((h - TGT) ** 2)

    for _ in range(3):
        opt.zero_grad()
        h = torch.from_numpy(X2)
        for i in range(N_LAYERS):
            h = layer_fn({k: v[i] for k, v in stacked.items()}, h)
        ((h - torch.from_numpy(TGT)) ** 2).mean().backward()
        opt.step()
        upd, jstate = jopt.update(jax.grad(jloss)(jparams), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    for res in ranks:
        assert res["losses"][2] < res["losses"][0] and res["held"] == N_LAYERS // 2
        for k in ("w", "b"):
            np.testing.assert_allclose(res["params"][k], stacked[k].detach().numpy(), rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(res["params"][k], np.asarray(jparams[k]), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", ["vit_d2s2", "vit_d1s4"])
def test_vit_trunk_train_grads(runs, name):
    """``tests/test_pipeline.py:283``: the cross-entropy's gradients through
    the pipelined ViT equal the sequential model's: every encoder block's
    (summed over the stages and the data ranks), and the embedding's and
    the head's (summed over the data ranks)."""
    _, ranks = runs[name]
    model = ViT(**dict(TINY_VIT, in_channels=3), device="cpu")
    model.load_state_dict(from_flax(VIT_PARAMS), strict=True)
    _, logits = model(torch.from_numpy(VIT_X))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(LABELS))
    loss.backward()
    for res in ranks:
        np.testing.assert_allclose(res["loss"], loss.item(), rtol=1e-5)
        assert set(res["grads"]) == {n for n, _ in model.named_parameters()}
        for n, p in model.named_parameters():
            np.testing.assert_allclose(res["grads"][n], p.grad.numpy(), rtol=5e-4, atol=5e-5, err_msg=n)


def test_trainer_and_engine_over_a_stage_axis_equal_one_process(runs):
    """Over ``data=2 x stage=2``, ``SegTrainer`` and ``TTAEngine.evaluate``
    do what the reference's jit does with a stage axis its program does not
    name: each stage rank computes its data rank's step whole. Two SGD
    steps and a continual Tent evaluation of a small UNet3D equal one
    process's, and the two ranks of a stage group are equal bit for bit."""
    _, ranks = runs["replica"]
    one = CASES["replica"](None, **REPLICA)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        for got, want in zip(r["params"], one["params"]):
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=2e-6, err_msg=k)
        assert set(r["metrics"]) == set(one["metrics"])
        for k, v in one["metrics"].items():
            if isinstance(v, float):
                np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5, atol=1e-5, err_msg=k)
        for k, v in one["state"].items():
            np.testing.assert_allclose(r["state"][k], v, rtol=1e-5, atol=2e-6, err_msg=k)
    for s in (0, 2):  # ranks (d, 0) and (d, 1): one stage group
        for k, v in ranks[s]["params"][-1].items():
            np.testing.assert_array_equal(v, ranks[s + 1]["params"][-1][k], err_msg=k)


def test_chip_smoke_stage_axis_phase_at_fixture_size(runs):
    """chip_smoke.py's phase 27 on the CPU at fixture size (a ViT of hidden
    32, depth 4, on [8, 32, 32, 3]): the sequential run
    (``stage_axis_prepare``), its rank side in the file's four gloo ranks on
    ``data=2 x stage=2`` (``run_axes_jobs``), and ``stage_axis_compare``
    within the phase's limits; each stage holds half the blocks."""
    import chip_smoke

    out = chip_smoke.stage_axis_compare("cpu", runs["phase27"][0])
    assert out["logits_max_rel"] <= chip_smoke.PP_LOGIT_REL
    assert out["train"]["loss_rel"] <= chip_smoke.PP_LOSS_REL and out["train"]["grad_rel"] <= chip_smoke.PP_GRAD_REL
    assert out["train"]["losses"][1] < out["train"]["losses"][0]
    for r in out["ranks"]:
        assert r["block_bytes"] * 2 == out["one"]["block_bytes"]
