"""The evaluation slice as a whole: the port's ``TTAEngine.evaluate`` with
``SegmentationEvaluationStrategy`` (multimodal_tta_tpu_torch/tta/engine.py,
evaluation/seg_eval.py) against the JAX package's, on the dryrun UNet3D with
the same flax weights and the same batches — two domains, a short last
batch, HECKTOR on-device normalisation, surface metrics, NSD and the loss on
— for no adaptation, episodic Tent and continual Tent.

Tolerance: identical key sets and every value within 1e-4 absolute (f32
forwards whose logits agree to ~1e-5, thresholded into the same masks; the
metrics of equal masks differ only by f32 rounding).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core.train_state import TrainState
from multimodal_tta_tpu.evaluation import SegmentationEvaluationStrategy as JaxStrategy
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu.tta.engine import TTAEngine as JaxTTAEngine
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.data.prefetch import prefetch_to_device
from multimodal_tta_tpu_torch.evaluation import seg_eval
from multimodal_tta_tpu_torch.evaluation.seg_eval import SegmentationEvaluationStrategy
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.registry import get_evaluation_strategy
from multimodal_tta_tpu_torch.tta.engine import TTAEngine
from tests._torch_port import DEVICE_TRANSFORM, DRYRUN, HECKTOR_POLICY, load_flax, np_params, randomize

torch.set_num_threads(1)

ATOL = 1e-4
SHAPE = (16, 16, 16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(method="none", episodic=True, **evaluation):
    ev = {"seg": {"region_order": ["gtvt"], "threshold": 0.3, "spacing": [3.0, 1.0, 1.0]},
          "surface": {"enable": True, "nsd_tol": 2.0}, "loss": {"report_loss": True}}
    ev.update(evaluation)
    return {
        "task": {"seed": 0, "eval_strategy": "seg_eval"},
        "dataset": {"modality_order": ["ct", "pt"]},
        "training": {"criterion": {"sigmoid": True},
                     "data": {"transforms": {"on_device": True, "normalize": True,
                                             "intensity_policy": HECKTOR_POLICY}}},
        "evaluation": ev,
        "tta": {"method": method, "steps": 1, "lr": 1e-3, "optimizer": "sgd", "momentum": 0.9,
                "update": "norm", "episodic": episodic},
    }


def _ellipsoid(shape, center, radii):
    grids = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    return (sum(((g - c) / r) ** 2 for g, c, r in zip(grids, center, radii)) <= 1.0).astype(np.float32)


def _loader(seed=0):
    """3 batches: 2 + 2 + 1 samples, domains CHUM/CHGJ."""
    rng = np.random.RandomState(seed)
    out = []
    for n, domains in ((2, ["CHUM", "CHGJ"]), (2, ["CHGJ", "CHGJ"]), (1, ["CHUM"])):
        image = (rng.randn(n, *SHAPE, 2) * 100).astype(np.float32)
        label = np.stack([
            _ellipsoid(SHAPE, rng.uniform(6, 10, 3), rng.uniform(2.5, 5, 3)) for _ in range(n)
        ])[..., None]
        out.append({"image": image, "label": label, "domain": domains})
    return out


def _params(seed=1):
    x0 = np.zeros((1, *SHAPE, 2), np.float32)
    return randomize(np_params(JaxUNet3D(**DRYRUN), x0, train=False), seed)


def _jax_evaluate(params, cfg_dict, loader):
    cfg = JaxConfigNode(cfg_dict)
    state = TrainState.create(apply_fn=JaxUNet3D(**DRYRUN).apply,
                              params=jax.tree_util.tree_map(jnp.asarray, params), tx=optax.identity())
    return JaxTTAEngine(cfg, mesh=None, device_transform=DEVICE_TRANSFORM).evaluate(state, loader)


def _torch_engine(cfg_dict):
    return TTAEngine(ConfigNode(cfg_dict), device_transform=DEVICE_TRANSFORM, device="cpu")


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], abs=ATOL), k


SCHEMA = {"gtvt_dc", "avg_dc", "miou", "jc", "loss", "gtvt_hd95", "avg_hd95", "gtvt_asd",
          "avg_asd", "gtvt_nsd", "avg_nsd"}
DOM_KEYS = {"gtvt_dc", "avg_dc", "miou", "gtvt_hd95", "avg_hd95", "gtvt_asd", "avg_asd",
            "gtvt_nsd", "avg_nsd"}


@pytest.mark.parametrize("method,episodic", [("none", True), ("tent", True), ("tent", False)],
                         ids=["none", "tent_episodic", "tent_continual"])
def test_engine_evaluate_matches_reference(method, episodic):
    params, loader = _params(), _loader()
    cfg = _cfg(method, episodic)
    want = _jax_evaluate(params, cfg, loader)
    model = load_flax(UNet3D(**DRYRUN, device="cpu"), params)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    engine = _torch_engine(cfg)
    assert engine.episodic is episodic or method == "none"
    got = engine.evaluate(model, loader)
    assert set(got) == SCHEMA | {f"dom/{d}/{k}" for d in ("CHUM", "CHGJ") for k in DOM_KEYS}
    _assert_same(got, want)
    assert 0.0 < got["gtvt_dc"] < 1.0 and got["loss"] > 0.0
    # the caller's model is what it was, and a second evaluate scores the same
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert engine.evaluate(model, loader) == got
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_tent_then_none_scores_the_source_model():
    """The order adapt-then-plain evaluation on one model: the plain run
    must not see adapted parameters."""
    params, loader = _params(2), _loader(1)
    model = load_flax(UNet3D(**DRYRUN, device="cpu"), params)
    none_first = _torch_engine(_cfg("none")).evaluate(model, loader)
    tent = _torch_engine(_cfg("tent", False)).evaluate(model, loader)
    assert tent != none_first
    assert _torch_engine(_cfg("none")).evaluate(model, loader) == none_first


def test_evaluate_restores_when_the_loop_raises():
    params = _params(3)
    model = load_flax(UNet3D(**DRYRUN, device="cpu"), params)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    loader = _loader(2)
    loader[1] = {"image": loader[1]["image"], "label": loader[1]["label"][..., 0]}  # label ndim
    with pytest.raises(ValueError, match="label must be"):
        _torch_engine(_cfg("tent", False)).evaluate(model, loader)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


class _Fixed(nn.Module):
    """A "model" that returns fixed logits."""

    def __init__(self, logits):
        super().__init__()
        self.register_buffer("logits", torch.from_numpy(logits))

    def forward(self, x):
        return self.logits


def _ball(shape, center, r):
    grids = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    return (sum((g - c) ** 2 for g, c in zip(grids, center)) <= r * r).astype(np.float32)


def _fixed_cfg(**surface):
    return {"evaluation": {"seg": {"region_order": ["gtvt"], "threshold": 0.5, "spacing": [1, 1, 1]},
                           "surface": dict(enable=True, **surface)},
            "training": {"criterion": {"sigmoid": True}}}


@pytest.mark.parametrize("surface", [{}, {"nsd_tol": 1.0}, {"asd_symmetric": True, "nsd_tol": [2.0]}],
                         ids=["hd_asd", "nsd", "symmetric_nsd_list"])
def test_fixed_logits_shifted_ball(surface):
    shape = (12, 12, 12)
    gt = _ball(shape, (6, 6, 6), 3)[None, ..., None]
    logits = np.where(_ball(shape, (7, 6, 6), 3)[None, ..., None] > 0, 5.0, -5.0).astype(np.float32)
    batch = {"image": gt, "label": gt, "domain": ["d1"]}
    cfg = _fixed_cfg(**surface)

    class FixedModel:
        def apply(self, variables, x, train=False):
            return jnp.asarray(logits)

    state = TrainState.create(apply_fn=FixedModel().apply, params={"w": jnp.zeros(1)}, tx=optax.identity())
    want = JaxStrategy(JaxConfigNode(cfg)).evaluate_epoch(state, [batch], mesh=None)
    got = SegmentationEvaluationStrategy(ConfigNode(cfg)).evaluate_epoch(_Fixed(logits), [batch], device="cpu")
    _assert_same(got, want)
    assert got["gtvt_hd95"] > 0 and got["dom/d1/avg_asd"] > 0 and got["loss"] == 0.0


def test_fixed_logits_empty_prediction_gets_the_diagonal():
    shape = (12, 12, 12)
    gt = _ball(shape, (6, 6, 6), 3)[None, ..., None]
    logits = np.full((1,) + shape + (1,), -5.0, np.float32)
    batch = {"image": gt, "label": gt, "domain": None}
    got = SegmentationEvaluationStrategy(ConfigNode(_fixed_cfg(nsd_tol=1.0))).evaluate_epoch(
        _Fixed(logits), [batch], device="cpu")
    diag = seg_eval.diag_mm_from_shape(12, 12, 12, (1, 1, 1))
    assert got["gtvt_hd95"] == pytest.approx(diag, abs=1e-4)
    assert got["gtvt_asd"] == pytest.approx(diag, abs=1e-4)
    assert got["gtvt_nsd"] == 0.0 and got["gtvt_dc"] < 1e-6
    assert got["dom/unknown/avg_hd95"] == pytest.approx(diag, abs=1e-4)  # "" -> unknown


@pytest.mark.parametrize("options", [
    {"flip_tta": {"enable": True, "axes": [1, 3]}},
    {"sliding_window": {"enable": True, "roi_size": [16, 16, 16], "overlap": 0.25}},
    {"surface": {"enable": False}, "loss": {"report_loss": False}},
], ids=["flip_tta", "sliding_window", "dice_only"])
def test_forward_options_match_reference(options):
    params, loader = _params(4), _loader(3)[:2]
    cfg = _cfg("none", **options)
    want = _jax_evaluate(params, cfg, loader)
    got = _torch_engine(cfg).evaluate(load_flax(UNet3D(**DRYRUN, device="cpu"), params), loader)
    _assert_same(got, want)


def test_transfer_dtype_and_n_valid():
    params, loader = _params(5), _loader(4)[:1]
    cfg = _cfg("none")
    cfg["training"]["transfer_dtype"] = "bfloat16"
    loader[0]["_n_valid"] = 1  # a padded duplicate row: only the first sample counts
    want = _jax_evaluate(params, cfg, loader)
    got = _torch_engine(cfg).evaluate(load_flax(UNet3D(**DRYRUN, device="cpu"), params), loader)
    _assert_same(got, want)
    assert "dom/CHGJ/avg_dc" not in got


def test_probs_fn_variance_needs_flip():
    strat = SegmentationEvaluationStrategy(ConfigNode(_fixed_cfg()))
    with pytest.raises(ValueError, match="flip_tta"):
        strat._probs_fn(_Fixed(np.zeros((1, 2, 2, 2, 1), np.float32)), with_variance=True)
    cfg = _fixed_cfg()
    cfg["evaluation"]["flip_tta"] = {"enable": True, "axes": [1]}
    logits = np.random.RandomState(0).randn(1, 4, 4, 4, 1).astype(np.float32)
    out = SegmentationEvaluationStrategy(ConfigNode(cfg))._probs_fn(_Fixed(logits), with_variance=True)(
        torch.zeros(1, 4, 4, 4, 2))
    assert len(out) == 3 and float(out[2].max()) > 0


@pytest.mark.parametrize("bad,match", [
    ({"seg": {"spacing": [1, 1]}}, "spacing"),
    ({"seg": {"region_order": ["a", "b"]}, "surface": {"enable": True, "nsd_tol": [1.0]}}, "nsd_tol"),
    ({"flip_tta": {"enable": True, "axes": [0, 1]}}, "flip_tta"),
])
def test_bad_config_raises(bad, match):
    with pytest.raises(ValueError, match=match):
        SegmentationEvaluationStrategy(ConfigNode({"evaluation": bad}))


def test_label_channels_must_match_region_order():
    strat = SegmentationEvaluationStrategy(ConfigNode(_fixed_cfg()))
    x = np.zeros((1, 4, 4, 4, 2), np.float32)
    with pytest.raises(ValueError, match="region_order"):
        strat.evaluate_epoch(_Fixed(x[..., :1]), [{"image": x, "label": x}], device="cpu")


def test_helpers_match_reference():
    from multimodal_tta_tpu.evaluation import seg_eval as jseg

    for x in (None, ["a", 3], "site", np.array(4), np.array([1, 2]), np.array([1, 2, 3]), 7):
        assert seg_eval.as_list_str(x, 2) == jseg.as_list_str(x, 2)
    assert seg_eval.diag_mm_from_shape(48, 144, 144, (3.0, 1.0, 1.0)) == \
        jseg.diag_mm_from_shape(48, 144, 144, (3.0, 1.0, 1.0))
    acc, jacc = seg_eval._Accum(2), jseg._Accum(2)
    vals, valid = np.array([[0.5, 0.25], [1.0, 0.75]]), np.array([[True, False], [True, False]])
    acc.add(vals, valid)
    jacc.add(vals, valid)
    assert acc.means() == jacc.means() == [0.75, 0.0]
    assert acc.valid_mean() == jacc.valid_mean() == 0.75


@pytest.mark.parametrize("best_metric,best_mode,stats,best,want", [
    (None, "max", {"loss": 0.4}, {"loss": 0.5}, True),
    (None, "max", {"loss": 0.6}, {"loss": 0.5}, False),
    ("avg_dc", "max", {"avg_dc": 0.7}, {"avg_dc": 0.6}, True),
    ("avg_hd95", "min", {"avg_hd95": 9.0}, {"avg_hd95": 5.0}, False),
    ("avg_dc", "max", {}, {}, False),
])
def test_is_best_model(best_metric, best_mode, stats, best, want):
    cfg = {"evaluation": {"best_metric": best_metric, "best_mode": best_mode}}
    assert SegmentationEvaluationStrategy(ConfigNode(cfg)).is_best_model(stats, best) is want
    assert JaxStrategy(JaxConfigNode(cfg)).is_best_model(stats, best) is want


def test_prefetch_to_device():
    batches = [{"image": np.full((2, 3, 2), i + 0.5, np.float32), "label": np.ones((2, 3, 1), np.float32),
                "domain": ["a", "b"], **({"_n_valid": 1} if i == 1 else {})} for i in range(4)]
    seen = []

    def gen():
        for b in batches:
            seen.append(len(seen))
            yield b

    stream = prefetch_to_device(gen(), "cpu", depth=2, image_transfer_dtype=torch.float16,
                                label_transfer_dtype=torch.uint8)
    first = next(stream)
    assert len(seen) == 2  # two batches ahead of the consumer
    rest = list(stream)
    out = [first] + rest
    assert [b["_n_valid"] for b in out] == [2, 1, 2, 2]
    assert all(b["image"].dtype == torch.float16 and b["label"].dtype == torch.uint8 for b in out)
    assert [float(b["image"][0, 0, 0]) for b in out] == [0.5, 1.5, 2.5, 3.5]
    assert out[0]["domain"] == ["a", "b"]
    assert list(prefetch_to_device([{"meta": 1}], "cpu"))[0]["_n_valid"] == 0


def test_registry_and_cuda_default(monkeypatch):
    assert get_evaluation_strategy("seg_eval") is SegmentationEvaluationStrategy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTAEngine(ConfigNode(_cfg()))
    x = np.zeros((1, 4, 4, 4, 1), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SegmentationEvaluationStrategy(ConfigNode(_fixed_cfg())).evaluate_epoch(
            _Fixed(x), [{"image": x, "label": x}])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(prefetch_to_device([{"image": x}]))


def test_port_imports_nothing_of_jax():
    """No module of the port (its CLIs included) and not chip_smoke.py imports
    jax, flax, optax, yaml, tqdm, pandas or the JAX package."""
    banned = re.compile(
        r"^\s*(?:import|from)\s+(jax|flax|optax|yaml|tqdm|pandas|multimodal_tta_tpu)(?![\w])", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "multimodal_tta_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    assert {"train.py", "adapt.py", "predict.py"} <= {
        os.path.basename(f) for f in files if os.path.basename(os.path.dirname(f)) == "cli"}
    for path in files:
        with open(path) as fh:
            hits = banned.findall(fh.read())
        assert not hits, f"{path} imports {hits}"
