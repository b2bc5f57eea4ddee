"""Evaluation and adaptation over a split depth (``parallel/space.py:flip``,
Tent's windows, pl / eata / sar / cotta / memo, flip TTA, the sliding
window, ``evaluation/export.py`` and ``cli.predict``): four gloo ranks on
the CPU on a ``data=2 x space=2`` mesh against the one-process port on the
same global batches, and against the JAX package on a ``data=1 x space=2``
mesh of its CPU devices.

One spawn (``tests/_torch_sa_worker.py``, which imports no JAX) runs every
rank case, and the same case functions in one more process without a mesh,
while the JAX references run in threads here; chip_smoke's new phase-23
cases run at fixture size after the spawn, in its thread. The flagship
fixture (depth 16, strides 2, 2, 2) splits levels 16, 8 and 4 over the two
space ranks and keeps the 2-plane bottleneck whole; Tent's windows of depth
8 and the sliding window's of depth 8 split the same way. A shallow UNet
(one stride) takes windows of depth 2, which do not split (a plane a rank):
they run whole on every space rank.

Tolerances:
  - ranks vs one process (f32, ``tests/test_torch_space_parallel.py``'s):
    entropies, SAR's EMA within 1e-5 relative; adapted tensors and CoTTA's
    teacher within 1e-5 relative plus 2e-6; predictions equal on >= 99.99%
    of voxels; metrics within 1e-6; SAR's resets equal; every rank alike;
    the evaluator's logits, probabilities and variance within 1e-6 of the
    larger of 1 and their largest magnitude; the depth flip and its
    gradient equal ``torch.flip``'s on the gathered volume exactly;
    ``cli.predict``'s masks and file names byte for byte (the NIfTI bytes:
    the gzip header holds a time stamp), its manifest's rows equal but for
    the float triage column (a mean of the uncertainty map), which like the
    probability and uncertainty volumes agrees within 1e-4 (f32 sums in
    another order, carried through two continual MEMO batches, move a
    probability by up to 2.4e-5 here: these cannot be equal byte for
    byte);
  - against the JAX package (each adapter's first batch; the evaluator's
    forward with flip TTA around the sliding window, what evaluation and
    the export score): ``assert_adapted_close``'s 1e-3 for the adapted
    tensors, the entropies within 1e-5 relative, predictions on >= 99.9% of
    voxels (``assert_preds_close``), the probabilities and variance within
    1e-4 absolute.
"""

import concurrent.futures
import gzip
import os

import jax
import numpy as np
import pytest
import torch

import multimodal_tta_tpu.tta  # noqa: F401  (every method registered before the reference's threads look one up)
from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.evaluation.seg_eval import SegmentationEvaluationStrategy as JaxSegEval
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_tta_tpu.parallel.mesh import shard_batch as jax_shard_batch
from multimodal_tta_tpu.registry import get_tta_method as jax_get_tta_method
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.data import nifti
from multimodal_tta_tpu_torch.data.synthetic import make_hecktor_fixture
from multimodal_tta_tpu_torch.models.convert import unet3d_from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.parallel import space as sp
from multimodal_tta_tpu_torch.registry import get_tta_method

from _torch_sa_worker import spawn
from _torch_port import (
    DEVICE_TRANSFORM,
    JaxDraws,
    assert_adapted_close,
    assert_preds_close,
    jax_state,
    random_flax_params,
    tta_config,
)

torch.set_num_threads(2)

DATA, SPACE = 2, 2
MK = dict(in_channels=2, num_classes=1, channels=(4, 8, 16, 32), strides=(2, 2, 2), num_res_units=2)
SHALLOW = dict(in_channels=2, num_classes=1, channels=(4, 8), strides=(2,), num_res_units=2)
SHAPE = (16, 32, 32, 2)
SURFACE = {"seg": {"region_order": ["GTV"], "threshold": 0.3, "spacing": [1.0, 1.0, 1.0]},
           "surface": {"enable": True, "nsd_tol": 1.0}, "loss": {"report_loss": True}}
METHODS = ("pl", "eata", "sar", "cotta", "memo")
KNOBS = {
    "pl": dict(steps=2, lr=1e-2, pl={"conf_threshold": 0.6}),
    "eata": dict(steps=2, lr=1e-2, entropy_focus="uncertain", reliability={"margin_ratio": 1.0},
                 fisher={"batches": 1, "lambda": 50.0}),
    "sar": dict(steps=2, lr=0.2, rho=0.5, margin_ratio=1.0),
    "cotta": dict(steps=2, lr=1e-2, ema=0.9, n_views=2, restore={"enabled": True, "prob": 0.2}),
    "memo": dict(steps=1, lr=1e-2, n_views=3, serve="marginal", restore={"enabled": True, "prob": 0.2},
                 modality_dropout={"enabled": True, "prob": 0.5}),
}
POST_DRAWS = ("cotta", "memo")  # the teacher's / the marginal's post-update views
N_VALID = [4, 3]  # the second batch ragged: data rank 1 holds a padded row
SPLIT_WINDOW = [8, 16, 16]
WHOLE_WINDOW = [2, 16, 16]


def _tent_cfg(**tta):
    cfg = tta_config(**tta)
    cfg["training"]["compute_dtype"] = "float32"
    return cfg


def _method_cfg(method: str, episodic: bool) -> dict:
    knobs = dict(KNOBS[method])
    if method == "sar" and episodic:
        knobs["reset_floor_ratio"] = 1.0  # the recovery fires at every step
    if method == "memo" and episodic:
        knobs["entropy_focus"] = "uncertain"  # the marginal's self-normalized entropy (continual: the mean)
    return _tent_cfg(method=method, episodic=episodic, **knobs)


# SAR's filter at 0.9 H_max: each sample's whole score (about 0.97 H_max on
# this fixture) is above it and a slab's part (about half) below it
SAR_FILTERED_CFG = _tent_cfg(method="sar", episodic=False, steps=1, lr=0.2, rho=0.5, margin_ratio=0.9)
WINDOW_CFG = _tent_cfg(steps=2, lr=1e-2, episodic=False, loss="entropy+consistency",
                       window={"enabled": True, "roi_size": SPLIT_WINDOW, "windows_per_step": 2})
WHOLE_WINDOW_CFG = _tent_cfg(steps=2, lr=1e-2, episodic=True, entropy_focus="uncertain",
                             reliability={"enabled": True, "margin_ratio": 0.8},
                             window={"enabled": True, "roi_size": WHOLE_WINDOW, "windows_per_step": 2})


def _eval_cfg(tta: dict, **evaluation) -> dict:
    cfg = _tent_cfg(**tta)
    cfg["evaluation"] = dict(SURFACE, **evaluation)
    return cfg


FLIP = {"enable": True, "axes": [1, 2, 3]}
EVAL_CFGS = {
    "eval_flip": (MK, _eval_cfg(dict(episodic=False, lr=1e-2), flip_tta=FLIP)),
    "eval_sliding": (MK, _eval_cfg(dict(method="none"), sliding_window={"enable": True, "roi_size": SPLIT_WINDOW,
                                                                        "overlap": 0.5})),
    "eval_sliding_whole": (SHALLOW, _eval_cfg(dict(method="none"), sliding_window={
        "enable": True, "roi_size": [2, 32, 32], "overlap": 0.5, "mode": "constant"})),
}
# three windows of depth 8 overlapping across the two ranks' slabs, each split
PROBS_CFG = _eval_cfg(dict(method="none"), flip_tta=FLIP, sliding_window={"enable": True, "roi_size": [8, 32, 32],
                                                                          "overlap": 0.5})


def _params(seed: int, kw=MK):
    return random_flax_params(JaxUNet3D(**kw), (1,) + SHAPE, seed)


def _batches(sizes, seed: int, label: bool = False):
    rng = np.random.RandomState(seed)
    out = []
    for b in sizes:
        x = (rng.randn(b, *SHAPE) * 100).astype(np.float32)
        y = (rng.rand(b, *SHAPE[:-1], 1) > 0.7).astype(np.float32)
        out.append({"image": x, "label": y, "domain": ["CHUM", "CHGJ", "CHUM", "CHGJ"][:b]} if label else x)
    return out


ADAPT_BATCHES = _batches([4, 4], 1)


def _draws(cfg: dict, kw: dict, jp, post: bool) -> list:
    """The reference's draws for each global batch (``JaxDraws``)."""
    port = get_tta_method(cfg["tta"]["method"])(ConfigNode(cfg).tta, config=ConfigNode(cfg), device="cpu")
    port._bind(UNet3D(**kw, device="cpu"))
    md = JaxDraws(port, jp)
    return [md(x.shape, n, post=post) for x, n in zip(ADAPT_BATCHES, N_VALID)]


def _predict_argv(tmp: str) -> list:
    """``cli.predict`` with continual MEMO, flip TTA and the uncertainty and
    probability volumes on a HECKTOR21 fixture of (16,16,16) volumes (three
    test cases: a batch of 2 and a ragged one)."""
    return [f"dataset.manifest_csv={tmp}/data/manifest.csv", "dataset.expected_shape=[16,16,16]",
            "dataset.val_per_center=1", "training.batch_size=2", "training.eval_batch_size=2",
            "training.num_workers=0", "training.compute_dtype=float32",
            "training.data.transforms.image_size=[16,16,16]", "model.channels=[2,4,8,16,32]",
            "model.num_res_units=1", "tta=memo", "tta.episodic=false", "tta.lr=0.05", "tta.n_views=2",
            "evaluation.flip_tta.enable=true", "predict.save_uncertainty=true", "predict.save_prob=true",
            f"task.save_dir={tmp}/outputs"]


def _payloads(tmp: str) -> dict:
    jp, jp_shallow = _params(5), _params(6, SHALLOW)
    state, shallow = unet3d_from_flax(jp), unet3d_from_flax(jp_shallow)
    out = {}
    for method in METHODS:
        for episodic in (True, False):
            cfg = _method_cfg(method, episodic)
            out[f"{method}_{'episodic' if episodic else 'continual'}"] = ("adapter", dict(
                cfg=cfg, name="unet", model_kw=MK, state=state, batches=ADAPT_BATCHES, n_valid=N_VALID,
                draws=_draws(cfg, MK, jp, method in POST_DRAWS), device_transform=DEVICE_TRANSFORM))
    out["sar_filtered"] = ("adapter", dict(cfg=SAR_FILTERED_CFG, name="unet", model_kw=MK, state=state,
                                           batches=ADAPT_BATCHES, n_valid=N_VALID, device_transform=DEVICE_TRANSFORM))
    out["tent_windows"] = ("adapter", dict(cfg=WINDOW_CFG, name="unet", model_kw=MK, state=state,
                                           batches=ADAPT_BATCHES, n_valid=N_VALID,
                                           draws=_draws(WINDOW_CFG, MK, jp, False), device_transform=DEVICE_TRANSFORM))
    out["tent_windows_whole"] = ("adapter", dict(cfg=WHOLE_WINDOW_CFG, name="unet", model_kw=SHALLOW, state=shallow,
                                                 batches=ADAPT_BATCHES, n_valid=N_VALID,
                                                 draws=_draws(WHOLE_WINDOW_CFG, SHALLOW, jp_shallow, False),
                                                 device_transform=DEVICE_TRANSFORM))
    for name, (kw, cfg) in EVAL_CFGS.items():
        out[name] = ("evaluate", dict(cfg=cfg, name="unet", model_kw=kw, state=shallow if kw is SHALLOW else state,
                                      batches=_batches([4, 3], 2, label=True), device_transform=DEVICE_TRANSFORM))
    out["probs"] = ("probs", dict(cfg=PROBS_CFG, name="unet", model_kw=MK, state=state,
                                  image=_batches([4], 3)[0]))
    rng = np.random.RandomState(4)
    for dims in ((1,), (1, 2, 3)):
        x, w = (rng.randn(4, 16, 6, 5, 3).astype(np.float32) for _ in range(2))
        out[f"flip_{len(dims)}"] = ("flip", dict(x=x, w=w, dims=dims))
    make_hecktor_fixture(f"{tmp}/data", shape=(16, 16, 16), centers={"CHUS": 3, "CHUM": 3, "CHGJ": 3})
    out["predict"] = ("predict", dict(argv=_predict_argv(tmp), root=tmp, mesh_argv=["training.mesh.space=2"]))
    return out


# ---- the JAX references on a data=1 x space=2 mesh of the CPU devices -------------


def _jax_mesh():
    return jax_make_mesh(jax.devices()[:2], data=1, space=2)


def _jax_adapter(payload: dict, kw: dict, jp):
    """The JAX adapter of ``payload``'s config in strict mode on its first
    global batch: the adapted state, entropies and predictions."""
    cfg = JaxConfigNode(payload["cfg"])
    mesh = _jax_mesh()
    state = jax_state(jp, module=JaxUNet3D(**kw))
    with mesh:
        adapter = jax_get_tta_method(cfg.tta.method)(cfg.tta, config=cfg, mesh=mesh,
                                                      device_transform=DEVICE_TRANSFORM)
        fn = adapter.make_adapt_predict_fn(state, threshold=0.3, predict_mode="post")
        cur, ents, preds = state, [], []
        for x, n in zip(payload["batches"][:1], payload["n_valid"][:1]):
            cur, pred = fn(cur, jax_shard_batch({"image": x}, mesh)["image"], n)
            ents.append(np.asarray(adapter._last_ents))
            preds.append(np.asarray(pred))
    return unet3d_from_flax(jax.tree_util.tree_map(np.asarray, cur.params)), ents, preds


def _jax_probs(payload: dict, jp) -> dict:
    strategy = JaxSegEval(JaxConfigNode(payload["cfg"]))
    mesh = _jax_mesh()
    with mesh:
        fn = jax.jit(strategy._probs_fn(jax_state(jp, module=JaxUNet3D(**MK)), with_variance=True))
        out = fn(jax_shard_batch({"image": payload["image"]}, mesh)["image"])
    return dict(zip(("logits", "prob", "var"), (np.asarray(t) for t in out)))


JAX_ADAPTERS = [f"{m}_continual" for m in METHODS] + ["tent_windows"]


class _Runs:
    """The spawn, then chip_smoke's new phase-23 cases at fixture size, in a
    thread; the JAX references in threads of their own; ``[name]`` waits
    for the spawn: ``(payload, [each rank's result], the one process's
    result)``."""

    def __init__(self, tmp: str):
        self.payloads = _payloads(tmp)
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.future = self.pool.submit(spawn, list(self.payloads.values()), f"{tmp}/ranks", DATA, SPACE, 400)
        self.phase = self.pool.submit(_phase_at_fixture_size, f"{tmp}/phase23")
        self.jax_pool = concurrent.futures.ThreadPoolExecutor(3)
        jp = _params(5)
        self.jax = {n: self.jax_pool.submit(_jax_adapter, self.payloads[n][1], MK, jp) for n in JAX_ADAPTERS}
        self.jax["probs"] = self.jax_pool.submit(_jax_probs, self.payloads["probs"][1], jp)

    def __getitem__(self, name):
        ranks, one = self.future.result()
        i = list(self.payloads).index(name)
        return self.payloads[name][1], [r[i] for r in ranks], one[i]


def _phase_at_fixture_size(root: str) -> dict:
    import chip_smoke

    return chip_smoke.space_adapters_phase("cpu", root, shape=(16, 32, 32), channels=(4, 8, 16, 32, 64),
                                           window_roi=(16, 16, 16), sliding_roi=(16, 16, 16), threads=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sa")
    (tmp / "ranks").mkdir()
    r = _Runs(str(tmp))
    yield r
    r.pool.shutdown()
    r.jax_pool.shutdown()


def _close_state(got: dict, want: dict, exact: bool = False) -> None:
    for k, v in want.items():
        if exact:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=2e-6, err_msg=k)


# ---------------------------------------------------------------------------
# against one process


@pytest.mark.parametrize("name", [f"{m}_{e}" for m in METHODS for e in ("episodic", "continual")]
                         + ["sar_filtered", "tent_windows", "tent_windows_whole"])
def test_adapters_over_the_space_axis_equal_one_process(runs, name):
    """pl, eata (its Fisher batch and its gate), sar (episodic: a recovery at
    every step; continual with a filter that holds out every sample by its
    whole score, which a slab's part would let through), cotta (2 views, mirrored depths among them) and memo (3
    views, modality dropout; episodic with the uncertain focus) episodic and
    continual, and Tent with windows
    of depth 8 (split) and 2 (whole on every space rank; the uncertain
    focus and the reliability gate), each in strict mode over the 2x2 ranks
    with the reference's draws for the global batch (a ragged second
    batch): entropies, adapted tensors, predictions, SAR's resets and EMA,
    CoTTA's teacher equal one process's; every rank alike."""
    _, ranks, one = runs[name]
    r0 = ranks[0]
    for a, b in zip(r0["ents"], one["ents"]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    _close_state(r0["state"], one["state"])
    for a, b in zip(r0["preds"], one["preds"]):
        assert a.shape == b.shape and (a == b).mean() >= 0.9999
    np.testing.assert_allclose(r0["em"], one["em"], rtol=1e-5)
    for ta, tb in zip(r0["teacher"], one["teacher"]):
        for a, b in zip(ta, tb):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6)
    assert r0["resets"] == one["resets"]
    for r in ranks[1:]:
        assert r["resets"] == r0["resets"]
        for key in ("ents", "em"):
            np.testing.assert_array_equal(r[key], r0[key])
        _close_state(r["state"], r0["state"], exact=True)
        for ta, tb in zip(r["teacher"], r0["teacher"]):
            for a, b in zip(ta, tb):
                np.testing.assert_array_equal(a, b)
    if name == "sar_episodic":  # the episodic reset and a recovery at each of the 2 steps
        assert one["resets"] == [3, 3]
    if name == "sar_filtered":  # the filter reads each sample's whole score: every sample held out
        source = {k: v.numpy() for k, v in runs[name][0]["state"].items()}
        _close_state(r0["state"], source, exact=True)
    if name.startswith("cotta"):
        assert len(one["teacher"]) == 2


@pytest.mark.parametrize("name", list(EVAL_CFGS))
def test_evaluation_over_the_space_axis_equals_one_process(runs, name):
    """``TTAEngine.evaluate`` over the 2x2 ranks (a ragged batch; Dice, IoU,
    the loss, HD95, ASD, NSD on the depth-gathered volumes) with flip TTA on
    axes 1, 2, 3 after a continual Tent step, with the sliding window
    (windows of depth 8: split), and with windows of depth 2 on the shallow
    UNet (whole on every space rank), returns on every rank one process's
    metrics and leaves the model as it was."""
    _, ranks, one = runs[name]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    assert set(ranks[0]["metrics"]) == set(one["metrics"]) and "avg_hd95" in one["metrics"]
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    _close_state(ranks[0]["state"], one["state"], exact=True)


def test_probabilities_and_variance_over_the_space_axis_equal_one_process(runs):
    """The evaluator's forward with flip TTA around the sliding window (the
    composition): the gathered logits, probabilities and mirror-ensemble
    variance of every rank equal one process's."""
    _, ranks, one = runs["probs"]
    for r in ranks:
        for k in ("logits", "prob", "var"):
            assert np.abs(r[k] - one[k]).max() <= 1e-6 * max(1.0, float(np.abs(one[k]).max())), k
    assert float(one["var"].max()) > 0.0


@pytest.mark.parametrize("name,dims", [("flip_1", (1,)), ("flip_3", (1, 2, 3))])
def test_flip_depth_and_its_gradient_equal_torch_flip(runs, name, dims):
    """``space.flip`` over the 2x2 ranks gives each rank its slab of
    ``torch.flip`` of the gathered volume; the gradient of ``sum(flip(x) *
    w)`` is ``torch.flip(w)``'s slab, through the same exchange."""
    payload, ranks, _ = runs[name]
    x, w = torch.from_numpy(payload["x"]).requires_grad_(True), torch.from_numpy(payload["w"])
    y = torch.flip(x, dims)
    (y * w).sum().backward()
    for r in ranks:
        np.testing.assert_array_equal(r["y"], y.detach().numpy())
        np.testing.assert_array_equal(r["grad"], x.grad.numpy())


def test_predict_cli_over_the_space_axis_writes_what_one_process_writes(runs):
    """``cli.predict`` with continual MEMO, flip TTA and the uncertainty maps
    over ``data=2 x space=2`` writes one process's files: the masks byte for
    byte (one space rank writes each case: no file is written twice), the
    manifest's rows on every rank (its triage column within 1e-4), the
    probability and uncertainty volumes within 1e-4."""
    payload, ranks, one = runs["predict"]
    root = payload["root"]
    triage = "mean_uncert_in_pred"
    assert len(one["rows"]) == 3
    for r in ranks:
        assert [{k: v for k, v in row.items() if k != triage} for row in r["rows"]] == \
            [{k: v for k, v in row.items() if k != triage} for row in one["rows"]]
        np.testing.assert_allclose([row[triage] for row in r["rows"]], [row[triage] for row in one["rows"]],
                                   rtol=0, atol=1e-4)
    got_dir, want_dir = f"{root}/pred_ranks", f"{root}/pred_one"
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and len(names) == 10
    for fname in names:
        if fname.endswith("_pred.nii.gz"):
            with gzip.open(f"{got_dir}/{fname}") as f, gzip.open(f"{want_dir}/{fname}") as g:
                assert f.read() == g.read(), fname
        elif fname.endswith(".nii.gz"):
            a, b = (nifti.load(f"{d}/{fname}").dataobj for d in (got_dir, want_dir))
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=fname)


# ---------------------------------------------------------------------------
# against the JAX package on its data=1 x space=2 mesh


@pytest.mark.parametrize("name", JAX_ADAPTERS)
def test_adapters_over_the_space_axis_match_the_reference(runs, name):
    """The 2x2 ranks' continual pl, eata, sar, cotta and memo and Tent with
    windows (split, with a consistency term) on their first batch against
    the JAX adapters on a ``data=1 x space=2`` mesh, both given the
    reference's draws."""
    adapted, ents, preds = runs.jax[name].result()
    _, ranks, _ = runs[name]
    r0 = ranks[0]
    assert_adapted_close({k: torch.from_numpy(v) for k, v in r0["states"][0].items()}, adapted,
                         unet3d_from_flax(_params(5)), r0["names"])
    np.testing.assert_allclose(r0["ents"][0], ents[0], rtol=1e-5)
    assert_preds_close(r0["preds"][:1], preds)


def test_probabilities_and_variance_match_the_reference(runs):
    """The 2x2 ranks' probabilities and variance (flip TTA on axes 1, 2, 3
    around the sliding window: the forward that evaluation and the export
    score) against the JAX evaluator's on its ``data=1 x space=2`` mesh."""
    want = runs.jax["probs"].result()
    r0 = runs["probs"][1][0]
    for k in ("prob", "var"):
        np.testing.assert_allclose(r0[k], want[k], atol=1e-4, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the split rule the fixtures rest on; chip_smoke's new phase-23 cases


def test_fixture_windows_split_and_whole():
    """Windows of depth 8 split over two space ranks (4 planes each) and so
    do the flagship's levels below them but the 2-plane bottleneck; windows
    of depth 2 do not (a plane a rank)."""

    class Axis:
        size = SPACE

    assert sp.splits(SPLIT_WINDOW[0], SPACE) and not sp.splits(WHOLE_WINDOW[0], SPACE)
    assert [a is not None for a in sp.level_axes(Axis(), SPLIT_WINDOW[0] // SPACE, MK["strides"])] == \
        [True, True, False, False]
    assert [a is not None for a in sp.level_axes(Axis(), SHAPE[0] // SPACE, MK["strides"])] == \
        [True, True, True, False]


def test_chip_smoke_space_adapters_at_fixture_size(runs):
    """chip_smoke.py's new phase-23 cases (``sa_run``) on the CPU at fixture
    size: two spawned gloo ranks on a ``space=2`` mesh against one process
    on the same global batches (pl, eata, sar, cotta, memo, Tent with
    windows, evaluation with flip TTA and with the sliding window), within
    the phase's own limits; no kernel launches on the CPU."""
    import chip_smoke

    out = runs.phase.result()
    c = out["compare"]
    assert out["backend"] == "gloo" and c["ranks"] == 2
    assert set(c["cases"]) == set(out["cases"]) == set(chip_smoke.SA_CASES)
    for name, case in c["cases"].items():
        assert case["ents_max_rel"] <= chip_smoke.SP_LOSS_REL, (name, case)
        assert case["delta_rel_l2"] <= chip_smoke.SP_DELTA_REL, (name, case)
        assert case["pred_agree"] >= chip_smoke.SP_PRED_AGREE, (name, case)
        assert case["metrics_max_abs"] <= chip_smoke.DP_METRIC_ABS, (name, case)
    assert all(v == 0 for r in out["ranks"] for case in r["launches"].values() for v in case.values())
    # every split norm call went through the phase's check
    for r in out["ranks"]:
        split = r["check"]["split"]
        assert set(split) == {f"{k} float32" for k in chip_smoke.SplitCheck.OPS.values()}
        assert all(v["calls"] > 0 and v["max_abs_err"] == 0.0 for v in split.values())
