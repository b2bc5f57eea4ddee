"""The port's other TTA methods (multimodal_tta_tpu_torch/tta/: pl, eata,
norm, sar, cotta, memo) against the JAX package's on the same dryrun UNet3D
weights, batches and random draws (``tests/_torch_port.py`` ``JaxDraws``),
in sigmoid and softmax mode; what each method carries (SAR's entropy EMA,
CoTTA's teacher, EATA's Fisher estimate); every constructor ``ValueError``
of the reference; the registry.

Tolerances (those of tests/test_torch_tent.py): adapted-minus-source deltas
of the 36 norm affines within a relative L2 of 1e-3; entropy traces within
1e-5 relative; predictions equal on >= 99.9% of voxels; SAR's EMA within
1e-5 relative; the CoTTA teacher's deltas from source within 1e-3 relative
L2 (the EMA of the adapted values); EATA's Fisher estimate within 1e-4
relative. SAR's perturbation ``rho * g / ||g||`` is normalized, so it needs
no wider bound: a 1e-5 error in g moves it by 1e-5 relative. MEMO's
accumulated gradient equals direct autograd of the marginal objective
within 1e-4 relative L2 (f32 sums over 4 views in another order).
"""

import jax
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.tta.cotta import CottaAdapter as JaxCotta
from multimodal_tta_tpu.tta.eata import EataAdapter as JaxEata
from multimodal_tta_tpu.tta.memo import MemoAdapter as JaxMemo
from multimodal_tta_tpu.tta.norm_adapt import NormAdapter as JaxNorm
from multimodal_tta_tpu.tta.pl import PseudoLabelAdapter as JaxPL
from multimodal_tta_tpu.tta.sar import SarAdapter as JaxSar
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.models.convert import flax_path, unet3d_from_flax, variables_from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.registry import get_tta_method
from multimodal_tta_tpu_torch.tta import (
    CottaAdapter,
    EataAdapter,
    MemoAdapter,
    NormAdapter,
    PseudoLabelAdapter,
    SarAdapter,
    TentAdapter,
    TTAEngine,
)
from multimodal_tta_tpu_torch.tta.memo import marginal_entropy
from multimodal_tta_tpu_torch.tta.tent import norm_param_mask
from tests._torch_port import (
    DEVICE_TRANSFORM,
    DRYRUN,
    SMALL,
    SMALL_SHAPE,
    assert_adapted_close,
    assert_preds_close,
    assert_stats_close,
    bn_unet_variables,
    dryrun_params,
    jax_state,
    load_flax,
    run_jax_adapter,
    run_torch_adapter,
    tta_config,
    volumes,
)

torch.set_num_threads(2)

THRESHOLD = 0.3
NORM = [n for n, m in norm_param_mask(UNet3D(**DRYRUN, device="cpu")).items() if m]


def _compare(jcls, tcls, cfg, batches, n_valid=2, mode="post", *, seed=0, softmax=False):
    nc = 2 if softmax else 1
    params = dryrun_params(seed, nc)
    j = run_jax_adapter(jcls, params, cfg, batches, n_valid, mode, THRESHOLD, num_classes=nc)
    t = run_torch_adapter(tcls, params, cfg, batches, n_valid, mode, THRESHOLD, num_classes=nc)
    assert_adapted_close(t[0], j[0], unet3d_from_flax(params), NORM)
    assert len(t[1]) == len(j[1])
    for a, b in zip(t[1], j[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert_preds_close(t[2], j[2])
    return j, t, params


def _jax_tree(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---- pl ------------------------------------------------------------------
@pytest.mark.parametrize("softmax", [False, True], ids=["sigmoid", "softmax"])
def test_pl_matches(softmax):
    cfg = tta_config("pl", softmax=softmax, steps=2, lr=5e-2, pl={"conf_threshold": 0.6})
    _compare(JaxPL, PseudoLabelAdapter, cfg, volumes(1, seed=1), n_valid=1, seed=1, softmax=softmax)
    assert PseudoLabelAdapter(ConfigNode(cfg).tta, device="cpu").loss_mode == "pl"


# ---- eata ------------------------------------------------------------------
def test_eata_matches_with_its_fisher_estimate():
    cfg = tta_config("eata", steps=2, lr=5e-2, episodic=False, predict="inline", entropy_focus="uncertain",
                     reliability={"margin_ratio": 0.95}, fisher={"lambda": 20.0, "batches": 2})
    j, t, _ = _compare(JaxEata, EataAdapter, cfg, volumes(3, seed=2), mode="inline", seed=2)
    jad, tad = j[3], t[3]
    assert tad.rel_enabled and tad.fisher_enabled and tad._fisher_n == 2
    jf = _jax_tree(jad._fisher_cached)
    tf = {flax_path(n): f.numpy() for n, f in zip(tad._names, tad._fisher_cached)}
    assert tf.keys() == jf.keys()
    got = np.concatenate([tf[k].ravel() for k in sorted(tf)])
    want = np.concatenate([jf[k].ravel() for k in sorted(jf)])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


# ---- norm ------------------------------------------------------------------
def test_norm_is_the_identity_without_batch_statistics(monkeypatch):
    params = dryrun_params(3)
    model = load_flax(UNet3D(**DRYRUN, device="cpu"), params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    warned = []
    for episodic in (True, False):
        cfg = ConfigNode(tta_config("norm", episodic=episodic))
        ad = get_tta_method("norm")(cfg.tta, config=cfg, device="cpu")
        monkeypatch.setattr(ad.logger, "warning", warned.append)
        fn = ad.make_adapt_fn(model)
        assert fn(model, torch.from_numpy(volumes(1, seed=3)[0]), 2) is model
        assert ad.episodic is episodic and ad.last_entropy is None
    assert len(warned) == 2 and all("no batch statistics" in w for w in warned)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    jcfg = JaxConfigNode(tta_config("norm"))
    state = jax_state(params)
    assert JaxNorm(jcfg.tta, config=jcfg).make_adapt_fn(state)(state, None, 2) is state
    bn = torch.nn.Sequential(torch.nn.BatchNorm3d(2))
    with pytest.raises(ValueError, match="torch's BatchNorm"):
        NormAdapter(cfg.tta, device="cpu").make_adapt_fn(bn)
    # a model with the port's BatchNorm (it raised before the BatchNorm
    # slice): the statistic recompute against the reference's over two
    # batches, episodic and continual, running statistics within 1e-5 of
    # each tensor's largest value; restore() puts the source statistics back
    v = bn_unet_variables(4)
    from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D

    jm = JaxUNet3D(**SMALL, norm="BATCH")
    for episodic in (True, False):
        jcfg, cfg = JaxConfigNode(tta_config("norm", episodic=episodic)), ConfigNode(tta_config("norm", episodic=episodic))
        state = jax_state(v["params"], module=jm, batch_stats=v["batch_stats"])
        jfn = JaxNorm(jcfg.tta, config=jcfg, device_transform=DEVICE_TRANSFORM).make_adapt_fn(state)
        model = UNet3D(**SMALL, norm="BATCH", device="cpu")
        model.load_state_dict(variables_from_flax(v), strict=True)
        source = {k: t.clone() for k, t in model.state_dict().items()}
        ad = NormAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device="cpu")
        fn = ad.make_adapt_fn(model)
        cur = state
        for x in volumes(2, seed=5, shape=(2,) + SMALL_SHAPE):
            cur = jfn(cur, jax.numpy.asarray(x), 2)
            assert fn(model, torch.from_numpy(x), 2) is model
            want = variables_from_flax({"params": v["params"], "batch_stats": cur.batch_stats})
            got = model.state_dict()
            assert assert_stats_close(got, want) == 20
            for k, t in got.items():
                assert torch.equal(t, source[k]) != k.endswith((".mean", ".var")), k
        ad.restore()
        assert all(torch.equal(t, source[k]) for k, t in model.state_dict().items())


# ---- sar -------------------------------------------------------------------
@pytest.mark.parametrize("softmax", [False, True], ids=["sigmoid", "softmax"])
def test_sar_matches_and_carries_its_ema(softmax):
    cfg = tta_config("sar", softmax=softmax, steps=1 if softmax else 2, lr=5e-2, episodic=False, predict="inline",
                     entropy_focus="uncertain", margin_ratio=0.95, reset_floor_ratio=0.05,
                     modality_dropout={"enabled": True, "prob": 0.5})
    j, t, _ = _compare(JaxSar, SarAdapter, cfg, volumes(2, seed=4), mode="inline", seed=4, softmax=softmax)
    jem, tem = float(j[3]._em), float(t[3]._em)
    assert np.isfinite(tem)
    np.testing.assert_allclose(tem, jem, rtol=1e-5)
    t[3].reset_optimizer()
    assert np.isnan(float(t[3]._em)) and not t[3]._opt.state


def test_sar_recovery_reset_snaps_to_source():
    """A floor above every monitor value: each step's update is undone, the
    optimizer and the EMA start afresh, in both packages."""
    cfg = tta_config("sar", steps=2, lr=5e-2, episodic=False, entropy_focus="uncertain",
                     margin_ratio=0.95, reset_floor_ratio=0.99)
    params = dryrun_params(5)
    batches = volumes(2, seed=5)
    j = run_jax_adapter(JaxSar, params, cfg, batches, 2, "post", THRESHOLD)
    t = run_torch_adapter(SarAdapter, params, cfg, batches, 2, "post", THRESHOLD)
    source = unet3d_from_flax(params)
    for n in source:
        assert torch.equal(t[0][n], source[n]) and torch.equal(j[0][n], source[n]), n
    assert np.isnan(float(t[3]._em)) and np.isnan(float(j[3]._em))
    for a, b in zip(t[1], j[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert_preds_close(t[2], j[2])
    assert all(not s for s in t[3]._opt.state.values())


# ---- cotta -----------------------------------------------------------------
def _teacher_close(jad, tad, params, rel=1e-3):
    source = {flax_path(k): v for k, v in unet3d_from_flax(params).items()}
    jt = _jax_tree(jad._teacher)
    tt = {flax_path(n): v for n, v in zip(tad._names, tad._teacher)}
    assert jt.keys() == tt.keys() and len(tt) == 36
    dj = torch.cat([torch.tensor(jt[k]).flatten() - source[k].flatten() for k in sorted(jt)])
    dt = torch.cat([tt[k].flatten() - source[k].flatten() for k in sorted(tt)])
    assert float(dj.norm()) > 0
    assert float((dt - dj).norm() / dj.norm()) < rel


@pytest.mark.parametrize("serve,mode,softmax,steps,views", [("teacher", "inline", False, 2, 3),
                                                            ("student", "post", False, 1, 2),
                                                            ("teacher", "post", True, 1, 2)],
                         ids=["teacher-inline", "student-post", "teacher-post-softmax"])
def test_cotta_matches_with_its_teacher(serve, mode, softmax, steps, views):
    cfg = tta_config("cotta", softmax=softmax, steps=steps, lr=5e-2, episodic=False, predict=mode, serve=serve,
                     ema=0.9, n_views=views, restore={"enabled": True, "prob": 0.2})
    j, t, params = _compare(JaxCotta, CottaAdapter, cfg, volumes(2, seed=6), mode=mode, seed=6, softmax=softmax)
    _teacher_close(j[3], t[3], params)
    t[3].reset_optimizer()
    assert all(torch.equal(a, b) for a, b in zip(t[3]._teacher, t[3]._source))


# ---- memo ------------------------------------------------------------------
@pytest.mark.parametrize("serve,mode,softmax,focus,steps,views", [
    ("marginal", "inline", False, "uncertain", 2, 3), ("clean", "post", False, "all", 1, 2),
    ("marginal", "post", True, "uncertain", 1, 2)], ids=["marginal-inline", "clean-post", "marginal-post-softmax"])
def test_memo_matches(serve, mode, softmax, focus, steps, views):
    cfg = tta_config("memo", softmax=softmax, steps=steps, lr=5e-2, episodic=True, predict=mode, serve=serve,
                     n_views=views, entropy_focus=focus, restore={"enabled": True, "prob": 0.1})
    _compare(JaxMemo, MemoAdapter, cfg, volumes(1, seed=7), n_valid=1, mode=mode, seed=7, softmax=softmax)


@pytest.mark.parametrize("softmax,focus", [(False, "uncertain"), (True, "all")])
def test_memo_accumulated_gradient_is_autograd_of_the_marginal(softmax, focus):
    nc = 2 if softmax else 1
    cfg = ConfigNode(tta_config("memo", softmax=softmax, n_views=4, entropy_focus=focus))
    model = load_flax(UNet3D(**dict(DRYRUN, num_classes=nc), device="cpu"), dryrun_params(8, nc))
    ad = MemoAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device="cpu")
    ad.make_adapt_fn(model)
    x = ad._norm_fn(torch.from_numpy(volumes(1, seed=8)[0]))
    w, denom = torch.tensor([1.0, 1.0]), torch.tensor(2.0)
    views = ad.step_draws(tuple(x.shape), 2)["views"]
    p_marg, _ = ad._marginal(x, views)
    ent, g_hat = marginal_entropy(p_marg, w, denom, sigmoid=not softmax, focus=focus)
    for p in ad._trainable:
        p.grad = None
    ad.accumulate_grads(x, views, g_hat)
    got = torch.cat([p.grad.flatten() for p in ad._trainable])

    # direct: the marginal through every view with the graph kept
    from multimodal_tta_tpu_torch.tta.cotta import apply_view, flipped_probs, view_combos

    combos = view_combos(x.dim(), True)
    probs = lambda v: ad._probs(model(v))  # noqa: E731
    p = probs(x)
    for i, v in enumerate(views):
        p = p + flipped_probs(probs, apply_view(x, v, ad.aug_noise), combos[i % len(combos)])
    p = p / 4.0
    pc = torch.clamp(p, 1e-6, 1 - 1e-6)
    if softmax:
        h = -(pc * torch.log(pc)).sum(-1)
    else:
        h = -(pc * torch.log(pc) + (1 - pc) * torch.log1p(-pc))
    ax = tuple(range(1, h.dim()))
    if focus == "uncertain":
        hw = h.detach()
        per = (h * hw).sum(ax) / torch.clamp(hw.sum(ax), min=1e-12)
    else:
        per = h.mean(ax)
    loss = (per * w).sum() / denom
    want = torch.cat([g.flatten() for g in torch.autograd.grad(loss, ad._trainable)])
    np.testing.assert_allclose(float(ent), float(loss.detach()), rtol=1e-6)
    assert float(want.norm()) > 0
    assert float((got - want).norm() / want.norm()) < 1e-4


# ---- the engine, the registry, the constructor errors ----------------------
def test_engine_restores_every_method_bitwise():
    """``TTAEngine.evaluate`` leaves the model as it found it and resets
    what the method carries."""
    model = load_flax(UNet3D(**DRYRUN, device="cpu"), dryrun_params(9))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(9)
    loader = [{"image": x, "label": (rng.rand(2, 16, 16, 16, 1) > 0.7).astype(np.float32), "domain": ["a", "b"]}
              for x in volumes(2, seed=9)]
    for method, extra in (("sar", {"reset_floor_ratio": 0.0}), ("cotta", {"n_views": 2}),
                          ("memo", {"n_views": 2})):
        cfg = tta_config(method, steps=1, lr=5e-2, episodic=False, **extra)
        cfg["evaluation"] = {"seg": {"region_order": ["gtvt"], "threshold": THRESHOLD}}
        cfg["dataset"] = {"modality_order": ["ct", "pt"]}
        engine = TTAEngine(ConfigNode(cfg), device_transform=DEVICE_TRANSFORM, device="cpu")
        m = engine.evaluate(model, loader)
        assert np.isfinite(m["avg_dc"])
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items()), method
        ad = engine.adapter
        if method == "sar":
            assert np.isnan(float(ad._em))
        if method == "cotta":
            assert all(torch.equal(a, b) for a, b in zip(ad._teacher, ad._source))


def test_registry_names():
    want = {"tent": TentAdapter, "pl": PseudoLabelAdapter, "eata": EataAdapter, "norm": NormAdapter,
            "sar": SarAdapter, "cotta": CottaAdapter, "memo": MemoAdapter}
    for name, cls in want.items():
        assert get_tta_method(name) is cls


ERRORS = [
    ("pl", {"loss": "entropy"}, "not a pseudo-label objective"),
    ("eata", {"reliability": {"enabled": False}, "fisher": {"enabled": False}}, "both reliability and fisher"),
    ("tent", {"fisher": {"enabled": True, "batches": 0}}, "fisher.batches must be >= 1"),
    ("sar", {"rho": 0.0}, "rho must be > 0"),
    ("sar", {"reset_ema_alpha": 1.0}, "reset_ema_alpha must be in"),
    ("sar", {"window": {"enabled": True}}, "incompatible with tta.window"),
    ("sar", {"early_stop": {"enabled": True}}, "duplicates SAR's own recovery"),
    ("sar", {"reliability": {"enabled": True}}, "reliable-sample filter is built in"),
    ("sar", {"restore": {"enabled": True}}, "tta.restore does not compose"),
    ("sar", {"loss": "pl"}, "tta.loss must be 'entropy'"),
    ("sar", {"fisher": {"enabled": True}}, "use method=eata"),
    ("cotta", {"serve": "both"}, "unknown serve mode"),
    ("cotta", {"n_views": 0}, "n_views must be >= 1"),
    ("cotta", {"ema": 1.5}, "ema must be in"),
    ("cotta", {"window": {"enabled": True}}, "incompatible with tta.window"),
    ("cotta", {"early_stop": {"enabled": True}}, "Tent-objective brake"),
    ("cotta", {"loss": "pl"}, "tta.loss does not apply"),
    ("cotta", {"reliability": {"enabled": True}}, "gates the entropy objective"),
    ("cotta", {"fisher": {"enabled": True}}, "anti-forgetting mechanisms"),
    ("memo", {"serve": "teacher"}, "unknown serve mode"),
    ("memo", {"n_views": 0}, "n_views must be >= 1"),
    ("memo", {"window": {"enabled": True}}, "incompatible with tta.window"),
    ("memo", {"early_stop": {"enabled": True}}, "Tent-objective brake"),
    ("memo", {"reliability": {"enabled": True}}, "does not compose with the marginal"),
    ("memo", {"fisher": {"enabled": True}}, "tta.restore \\(composes\\)"),
    ("memo", {"loss": "entropy+consistency"}, "tta.loss does not apply"),
    ("tent", {"loss": "mystery"}, "unknown loss mode"),
    ("tent", {"sync_over_mesh": False}, "sync_over_mesh=false is not supported"),
]


@pytest.mark.parametrize("method,tta,match", ERRORS, ids=[f"{m}-{i}" for i, (m, _, _) in enumerate(ERRORS)])
def test_constructor_errors_match_the_reference(method, tta, match):
    from multimodal_tta_tpu.registry import get_tta_method as jax_get

    cfg = tta_config(method, **tta)
    with pytest.raises(ValueError, match=match):
        jax_get(method)(JaxConfigNode(cfg).tta, config=JaxConfigNode(cfg), mesh=None)
    with pytest.raises(ValueError, match=match):
        get_tta_method(method)(ConfigNode(cfg).tta, config=ConfigNode(cfg), device="cpu")
