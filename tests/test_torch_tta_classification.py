"""The TTA methods' BatchNorm branches on the port against the JAX package:
the cases of tests/test_tta_classification.py (a trained BatchNorm CNN
under covariate shift, adapted through ``classifier_logits_apply``) for
tent, pl, eata, norm, sar, memo and cotta given the same random draws
(tests/_torch_port.py:JaxDraws), the registered resnet18 in an adapter, and
``TTAEngine.evaluate`` on a UNet3D with ``norm=BATCH`` for none, norm and
Tent (episodic and continual).

Tolerances on the tiny CNN. The reference's own f32 adaptation of it sits
2.95e-3 (tent) and 3.26e-3 (pl) relative L2 off the same reference run in
f64 (``jax_enable_x64``; measured on these batches: its f32 training-mode
BatchNorm loses digits in E[x^2] - E[x]^2 of the shifted data), where the
port's f32 run sits 1.6e-5 and 8.2e-5 off the port's f64 run, and the two
f64 runs agree. MEMO's marginal entropy at confident marginals loses
digits in any f32 run: there the port is 7.6e-5 off the reference and
1.7e-3 off its f64 run. So the port is held to the bound of ROADMAP.md §3
against the one of the two its case's rounding allows:
  - adapted-minus-source deltas of the BN affines within 1e-3 relative L2 of
    the reference or of the port's f64 run, and within 1e-2 of both;
  - running statistics within 1e-5 of each tensor's largest value of the
    f64 run and 3e-5 of the reference's (tests/_torch_port.py:
    assert_stats_close; the reference's are up to 1.05e-5 off);
  - entropy traces within 1e-3 relative of the reference's, predictions
    equal on >= 99% of samples.
The engine on the UNet3D (well conditioned): metrics within 1e-4 absolute
(tests/test_torch_seg_eval.py). Restores leave the model bitwise as it
was, buffers included.

MEMO and CoTTA run with ``aug_flip=false`` against the reference: on a
classifier's ``[B, C]`` output the reference mirrors the class axis back
with the input's spatial flip (and raises for a second spatial axis); the
port mirrors back only an output with the input's spatial axes
(ROADMAP.md §3), pinned by ``test_memo_flipped_views_of_a_classifier``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import tests.test_torch_seg_eval as tse
import tests.test_tta_classification as jcls
from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu.registry import get_tta_method as jax_get_tta_method
from multimodal_tta_tpu.tta.engine import TTAEngine as JaxTTAEngine
from multimodal_tta_tpu.tta.engine import classifier_logits_apply as jax_classifier_logits_apply
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.models.convert import flax_path, variables_from_flax
from multimodal_tta_tpu_torch.models.layers import BatchNorm, running_statistics
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.registry import get_model, get_tta_method
from multimodal_tta_tpu_torch.tta import TTAEngine, classifier_logits_apply, norm_param_mask
from multimodal_tta_tpu_torch.tta.memo import MemoAdapter
from tests._torch_port import DEVICE_TRANSFORM, SMALL, JaxDraws, assert_stats_close, bn_unet_variables, jax_state

torch.set_num_threads(2)


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax ``padding="SAME"`` of an NCHW tensor: (total // 2, total - total // 2)."""
    pads = []
    for n in reversed(x.shape[2:]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class TinyCls(nn.Module):
    """The port of tests/test_tta_classification.py:TinyCls (flax's names)."""

    def __init__(self, num_classes: int = 2):
        super().__init__()
        self.Conv_0 = nn.Conv2d(1, 8, 3, 2, bias=False)
        self.BatchNorm_0 = BatchNorm(8)
        self.Conv_1 = nn.Conv2d(8, 16, 3, 2, bias=False)
        self.BatchNorm_1 = BatchNorm(16)
        self.Dense_0 = nn.Linear(16, num_classes)
        self.eval()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = self.BatchNorm_0(F.conv2d(_same_pad(x, 3, 2), self.Conv_0.weight, stride=2), relu=True)
        x = self.BatchNorm_1(F.conv2d(_same_pad(x, 3, 2), self.Conv_1.weight, stride=2), relu=True)
        feats = x.mean(dim=(2, 3))
        return feats, self.Dense_0(feats)


@pytest.fixture(scope="module")
def trained():
    """The reference's tiny CNN trained 300 steps, and a shifted test set."""
    model, params, bstats = jcls.train_tiny()
    rng = np.random.RandomState(42)
    x_clean, y = jcls.make_data(rng, 128)
    return model, jax.device_get(params), jax.device_get(bstats), jcls.shift(x_clean, rng), y


def _tta(method: str, **tta):
    base = {"method": method, "steps": 2, "lr": 5e-2, "optimizer": "sgd", "momentum": 0.9, "update": "norm",
            "episodic": True, "entropy_focus": "all"}
    base.update(tta)
    return {"task": {"seed": 0}, "training": {"criterion": {"sigmoid": False, "softmax": True}}, "tta": base}


def _port_model(params, bstats) -> nn.Module:
    m = TinyCls()
    m.load_state_dict(variables_from_flax({"params": params, "batch_stats": bstats}), strict=True)
    return classifier_logits_apply(m)


def _run(method, cfg, trained, batches, mode=None):
    """The JAX adapter and the port's over ``batches`` (the port given the
    reference's draws); returns both final states as port state dicts, both
    entropy traces and both prediction lists."""
    model, params, bstats, _, _ = trained
    jcfg, pcfg = JaxConfigNode(cfg), ConfigNode(cfg)
    state = jax_state(params, module=model, batch_stats=bstats, apply_fn=jax_classifier_logits_apply(model))
    jad = jax_get_tta_method(method)(jcfg.tta, config=jcfg, mesh=None)
    tm = _port_model(params, bstats)
    tad = get_tta_method(method)(pcfg.tta, config=pcfg, device="cpu")
    if hasattr(tad, "batch_draws"):
        tad.batch_draws = JaxDraws(tad, params)
    if mode is None:
        jfn, tfn = jad.make_adapt_fn(state), tad.make_adapt_fn(tm)
    else:
        jfn = jad.make_adapt_predict_fn(state, threshold=0.5, predict_mode=mode)
        tfn = tad.make_adapt_predict_fn(tm, threshold=0.5, predict_mode=mode)
    cur, out = state, {"jax": ([], []), "port": ([], [])}
    for x, n_valid in batches:
        j = jfn(cur, jnp.asarray(x), n_valid)
        t = tfn(tm, torch.from_numpy(x), n_valid)
        cur = j if mode is None else j[0]
        if mode is not None:
            out["jax"][1].append(np.asarray(j[1]))
            out["port"][1].append(t[1].numpy())
        if jad.last_entropy is not None:
            out["jax"][0].append(np.asarray(jad._last_ents))
            out["port"][0].append(tad._last_ents.numpy())
    want = variables_from_flax({"params": jax.device_get(cur.params), "batch_stats": jax.device_get(cur.batch_stats)})
    return want, {k: v.detach().clone() for k, v in tm.state_dict().items()}, out, (tm, tad)


class TinyCls64(TinyCls):
    """The same model in f64 (the adapters hand it f32 images)."""

    def forward(self, x):
        return super().forward(x.double())


def _run_f64(method, cfg, trained, batches, mode=None):
    """The port's adapter on the f64 model over ``batches`` with the same
    draws: the adapted state dict (f64)."""
    _, params, bstats, _, _ = trained
    m = TinyCls64()
    m.load_state_dict(variables_from_flax({"params": params, "batch_stats": bstats}), strict=True)
    tm = classifier_logits_apply(m.double())
    pcfg = ConfigNode(cfg)
    tad = get_tta_method(method)(pcfg.tta, config=pcfg, device="cpu")
    if hasattr(tad, "batch_draws"):
        tad.batch_draws = JaxDraws(tad, params)
    fn = tad.make_adapt_fn(tm) if mode is None else tad.make_adapt_predict_fn(tm, threshold=0.5, predict_mode=mode)
    for x, n_valid in batches:
        fn(tm, torch.from_numpy(x), n_valid)
    return {k: v.detach().clone() for k, v in tm.state_dict().items()}


def _deltas(sd, source, names):
    return torch.cat([(sd[n].double() - source[n].double()).flatten() for n in names])


def _assert_close(want, got, source, exact, out=None):
    """``got`` (the port) against ``want`` (the reference) and ``exact``
    (the port's f64 run), at the module docstring's bounds."""
    norms = [n for n in source if n.rpartition(".")[2] in ("scale", "bias") and n.startswith("BatchNorm")]
    dt, dj = _deltas(got, source, norms), _deltas(want, source, norms)
    if float(dj.norm()) == 0.0:  # norm, and SAR reset to source: the affines stay
        assert float(dt.norm()) == 0.0
    else:
        rels = [float((dt - dr).norm() / dr.norm()) for dr in (dj, _deltas(exact, source, norms))]
        assert min(rels) < 1e-3 and max(rels) < 1e-2, rels
    for n in source:
        if n.rpartition(".")[2] in ("mean", "var"):
            assert not torch.equal(got[n], source[n]), n
        elif n not in norms:
            assert torch.equal(got[n], source[n]), n
    assert assert_stats_close(got, want, rel=3e-5) == 4
    assert assert_stats_close(got, exact) == 4
    if out is not None:
        for a, b in zip(out["port"][0], out["jax"][0]):
            np.testing.assert_allclose(a, b, rtol=1e-3)
        for a, b in zip(out["port"][1], out["jax"][1]):
            assert (a == b).mean() >= 0.99


def test_tent_recovers_accuracy_under_covariate_shift(trained):
    """The JAX file's Tent case (16 continual steps on the shifted batch):
    the port's adapted state equals the reference's, and recovers the
    accuracy the stale running statistics lost."""
    model, params, bstats, x, y = trained
    cfg = _tta("tent", steps=16, lr=1e-2, episodic=False)
    want, got, out, (tm, _) = _run("tent", cfg, trained, [(x, x.shape[0])])
    source = variables_from_flax({"params": params, "batch_stats": bstats})
    _assert_close(want, got, source, _run_f64("tent", cfg, trained, [(x, x.shape[0])]), out=out)
    tm.eval()

    def acc(sd):
        m = TinyCls()
        m.load_state_dict(sd)
        with torch.no_grad():
            return float((m(torch.from_numpy(x))[1].argmax(-1).numpy() == y).mean())

    assert acc(source) <= 0.85 and acc(got) >= 0.9 and acc(got) >= acc(source) + 0.1


CASES = {
    "tent_episodic_post": ("tent", {"steps": 2}, "post"),
    "tent_consistency_inline": ("tent", {"loss": "entropy+consistency", "episodic": False}, "inline"),
    "tent_early_stop": ("tent", {"steps": 4, "lr": 5e-2, "early_stop": {"enabled": True,
                                                                        "entropy_floor_ratio": 0.995}}, None),
    "pl": ("pl", {"pl": {"conf_threshold": 0.6}}, "post"),
    "eata": ("eata", {"episodic": False, "reliability": {"margin_ratio": 0.95},
                      "fisher": {"lambda": 20.0, "batches": 1}}, "inline"),
    "norm_episodic": ("norm", {"episodic": True}, None),
    "norm_continual": ("norm", {"episodic": False}, None),
    "sar": ("sar", {"episodic": False, "margin_ratio": 0.95, "reset_floor_ratio": 0.001}, "post"),
    "sar_reset": ("sar", {"episodic": False, "margin_ratio": 0.95}, "inline"),
    "memo": ("memo", {"n_views": 3, "aug_flip": False, "aug_noise": 0.05}, "post"),
    "memo_marginal_inline": ("memo", {"n_views": 2, "aug_flip": False, "serve": "marginal", "episodic": False},
                             "inline"),
    "cotta_teacher": ("cotta", {"n_views": 2, "aug_flip": False, "episodic": False,
                                "restore": {"enabled": True, "prob": 0.1}}, "post"),
    "cotta_student": ("cotta", {"n_views": 2, "aug_flip": False, "serve": "student"}, "post"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_method_bn_branch_matches_reference(case, trained):
    """Two batches of 32 shifted samples (the second a padded batch of 24
    valid rows) through each method's BN branch: params, running
    statistics, entropy traces and predictions against the reference."""
    method, tta, mode = CASES[case]
    _, params, bstats, x, _ = trained
    cfg = _tta(method, **tta)
    padded = x[32:64].copy()
    padded[24:] = 0.0
    batches = [(x[:32], 32), (padded, 24)]
    want, got, out, (tm, tad) = _run(method, cfg, trained, batches, mode)
    source = variables_from_flax({"params": params, "batch_stats": bstats})
    _assert_close(want, got, source, _run_f64(method, cfg, trained, batches, mode), out=out)
    tad.restore()
    assert all(torch.equal(t, source[k]) for k, t in tm.state_dict().items())


@pytest.mark.parametrize("focus", ["all", "uncertain"])
def test_per_sample_objectives_of_classifier_logits(focus):
    """``[B, C]`` logits have no spatial axes: each sample's objective is its
    own, as the reference's ``vmap`` gives it (torch reduces every dim for
    ``dim=()``, which summed the batch into every sample before the
    BatchNorm slice)."""
    from multimodal_tta_tpu.ops import losses as jl
    from multimodal_tta_tpu_torch.ops import losses as tl

    logits = np.random.RandomState(0).randn(6, 3).astype(np.float32) * 2.0
    want = jax.vmap(lambda lg: jl.entropy_loss(lg[None], sigmoid=False, focus=focus))(jnp.asarray(logits))
    got = tl.entropy_loss(torch.from_numpy(logits), sigmoid=False, focus=focus, per_sample=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    want = jax.vmap(lambda lg: jl.pseudo_label_loss(lg[None], sigmoid=False, conf_threshold=0.6))(jnp.asarray(logits))
    got = tl.pseudo_label_loss(torch.from_numpy(logits), sigmoid=False, conf_threshold=0.6, per_sample=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_memo_flipped_views_of_a_classifier(trained):
    """With ``aug_flip`` the views mirror the input's two spatial axes; the
    marginal of a classifier averages the views' class probabilities as
    they are (nothing to mirror back in ``[B, C]``)."""
    _, params, bstats, x, _ = trained
    cfg = ConfigNode(_tta("memo", n_views=3, aug_noise=0.0, aug_scale=0.0, aug_shift=0.0))
    tm = _port_model(params, bstats)
    ad = MemoAdapter(cfg.tta, config=cfg, device="cpu")
    ad._bind(tm)
    xb = torch.from_numpy(x[:16])
    views = ad.post_draws(tuple(xb.shape))
    p, _ = ad._marginal(xb, views)
    with torch.no_grad():
        tm.load_state_dict(_port_model(params, bstats).state_dict())
        tm.train()
        p0 = torch.softmax(tm(xb), -1)
        tm.eval()
        p1 = torch.softmax(tm(torch.flip(xb, dims=(1,))), -1)
        p2 = torch.softmax(tm(torch.flip(xb, dims=(2,))), -1)
    torch.testing.assert_close(p, (p0 + p1 + p2) / 3.0, rtol=1e-5, atol=1e-6)


def test_registered_resnet18_drops_into_the_adapter():
    """The JAX file's case on the port: only BN affines move, conv kernels
    stay, running statistics are recomputed; restore() puts all back."""
    m = get_model("resnet18").from_config(ConfigNode({"name": "resnet18", "num_classes": 4}), device="cpu", seed=0)
    w = classifier_logits_apply(m)
    source = {k: v.clone() for k, v in m.state_dict().items()}
    cfg = ConfigNode(_tta("tent", lr=1e-2))
    ad = get_tta_method("tent")(cfg.tta, config=cfg, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 32, 32, 3).astype(np.float32))
    ad.make_adapt_fn(w)(w, x, 4)
    mask = norm_param_mask(m)
    moved = {n: not torch.equal(t, source[n]) for n, t in m.state_dict().items()}
    assert all(moved[n] for n in mask if mask[n]) and not any(moved[n] for n in mask if not mask[n])
    assert all(moved[n] for n in running_statistics(m)) and not m.training
    assert ad.last_entropy is not None and np.isfinite(ad.last_entropy)
    ad.restore()
    assert all(torch.equal(t, source[n]) for n, t in m.state_dict().items())
    assert {flax_path(n) for n in mask if mask[n]} == {flax_path(n) for n, mod in m.named_modules()
                                                      if isinstance(mod, BatchNorm) for n in (f"{n}.scale", f"{n}.bias")}


@pytest.mark.parametrize("method,episodic", [("none", True), ("norm", True), ("norm", False), ("tent", True),
                                             ("tent", False)],
                         ids=["none", "norm_episodic", "norm_continual", "tent_episodic", "tent_continual"])
def test_engine_evaluate_on_a_bn_unet3d(method, episodic):
    """``TTAEngine.evaluate`` on the SMALL UNet3D with norm BATCH against the
    JAX engine (tests/test_torch_seg_eval.py's batches and metrics); the
    model, running statistics included, bitwise as it was afterwards."""
    v = bn_unet_variables(13)
    loader = tse._loader()
    cfg = tse._cfg(method, episodic)
    jm = JaxUNet3D(**SMALL, norm="BATCH")
    state = jax_state(v["params"], module=jm, batch_stats=v["batch_stats"])
    want = JaxTTAEngine(JaxConfigNode(cfg), mesh=None, device_transform=DEVICE_TRANSFORM).evaluate(state, loader)
    model = UNet3D(**SMALL, norm="BATCH", device="cpu")
    model.load_state_dict(variables_from_flax(v), strict=True)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    got = TTAEngine(ConfigNode(cfg), device_transform=DEVICE_TRANSFORM, device="cpu").evaluate(model, loader)
    tse._assert_same(got, want)
    assert all(torch.equal(t, before[k]) for k, t in model.state_dict().items()) and not model.training
