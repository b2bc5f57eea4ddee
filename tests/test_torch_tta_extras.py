"""The Tent extras of the port (multimodal_tta_tpu_torch/tta/tent.py) against
the JAX TentAdapter on the same dryrun UNet3D weights, batches and random
draws (``tests/_torch_port.py`` ``JaxDraws`` rebuilds the reference's draws
from its key-split order and hands them to the port): modality dropout,
windows, the consistency and pseudo-label objectives, early stop (relative
and absolute floor, with the frozen tail's trace), stochastic restore,
reliability gating, the Fisher anchor and its estimate, ``reset_optimizer``,
``make_forward_predict_fn``, inline vs post predictions.

Tolerances (those of tests/test_torch_tent.py): adapted-minus-source deltas
of the 36 norm affines within a relative L2 of 1e-3; entropy traces within
1e-5 relative (1e-4 where the objective is a self-normalized entropy of
few windows or a pseudo-label CE, whose f32 sums the two packages reduce in
another order: measured up to 2e-5); uint8 predictions equal on >= 99.9% of
voxels; the Fisher estimate within 1e-4 relative (squares of gradients that
agree to about 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.tta.tent import TentAdapter as JaxTentAdapter
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.models.convert import unet3d_from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.tta.tent import (
    TentAdapter,
    apply_crop_windows,
    norm_param_mask,
    reliability_weights,
    window_draws,
)
from tests._torch_port import (
    DEVICE_TRANSFORM,
    DRYRUN,
    assert_adapted_close,
    assert_preds_close,
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


def _compare(cfg, batches, n_valid=2, mode="post", *, params_seed=0, num_classes=1, floors=None,
             ent_rtol=1e-5):
    params = dryrun_params(params_seed, num_classes)
    j = run_jax_adapter(JaxTentAdapter, params, cfg, batches, n_valid, mode, THRESHOLD, floors, num_classes)
    t = run_torch_adapter(TentAdapter, params, cfg, batches, n_valid, mode, THRESHOLD, floors, num_classes)
    assert_adapted_close(t[0], j[0], unet3d_from_flax(params), NORM)
    assert len(t[1]) == len(j[1])
    for a, b in zip(t[1], j[1]):
        np.testing.assert_allclose(a, b, rtol=ent_rtol)
    assert_preds_close(t[2], j[2])
    return j, t


def test_modality_dropout_post_episodic_masked_sample():
    cfg = tta_config(steps=2, lr=1e-2, modality_dropout={"enabled": True, "prob": 0.5})
    _compare(cfg, volumes(1, seed=2), n_valid=1, mode="post", params_seed=2)


def test_windows_with_consistency_and_reliability():
    """Three random [16,16,16] windows of [16,32,32] volumes per step, drawn
    from the one valid sample; the windowed consistency term and the
    per-window reliability weights."""
    cfg = tta_config(steps=2, lr=5e-2, entropy_focus="uncertain", loss="entropy+consistency",
                     window={"enabled": True, "roi_size": [16, 16, 16], "windows_per_step": 3},
                     reliability={"enabled": True, "margin_ratio": 0.9})
    _compare(cfg, volumes(1, seed=3, shape=(2, 16, 32, 32, 2)), n_valid=1, mode="post", params_seed=3,
             ent_rtol=1e-4)


def test_windows_plain_objective_continual():
    cfg = tta_config(steps=2, lr=5e-2, episodic=False,
                     window={"enabled": True, "roi_size": [16, 16, 16], "windows_per_step": 2})
    _compare(cfg, volumes(2, seed=4, shape=(2, 16, 32, 32, 2)), mode=None, params_seed=4)


def test_consistency_objective_softmax():
    """The invariance term over softmax probabilities (sigmoid: the
    every-draw tests below)."""
    cfg = tta_config(steps=2, lr=1e-2, episodic=False, loss="entropy+consistency", softmax=True,
                     consistency={"weight": 2.0, "scale": 0.2, "shift": 0.3})
    _compare(cfg, volumes(2, seed=5), mode="inline", params_seed=5, num_classes=2)


@pytest.mark.parametrize("softmax", [False, True], ids=["sigmoid", "softmax"])
def test_pseudo_label_objectives(softmax):
    """``pl`` per sample (one sample masked out), and ``pl+consistency``."""
    nc = 2 if softmax else 1
    cfg = tta_config(steps=2, lr=5e-2, loss="pl", softmax=softmax, pl={"conf_threshold": 0.6})
    _compare(cfg, volumes(1, seed=6), n_valid=1, mode="post", params_seed=6, num_classes=nc, ent_rtol=1e-4)
    cfg = tta_config(steps=2, lr=5e-2, loss="pl+consistency", softmax=softmax, pl={"conf_threshold": 0.6})
    _compare(cfg, volumes(1, seed=7), mode="post", params_seed=7, num_classes=nc, ent_rtol=1e-4)


def _frozen(ents, floor):
    """Index of the first step whose entropy is below ``floor`` (None if none)."""
    below = [i for i, e in enumerate(ents) if e < floor]
    return below[0] if below else None


def test_early_stop_relative_floor():
    """A floor at 0.995 of the batch's first-step entropy: the second step
    lands below it, so its update is discarded and the state keeps the first
    step's (the reference masks it inside its scan)."""
    cfg = tta_config(steps=2, lr=3.0, entropy_focus="uncertain",
                     early_stop={"enabled": True, "entropy_floor_ratio": 0.995},
                     modality_dropout={"enabled": True, "prob": 0.5})
    j, t = _compare(cfg, volumes(1, seed=8), mode="post", params_seed=8)
    ents = j[1][0]
    assert _frozen(ents, 0.995 * ents[0]) == 1, ents  # the brake fired


def test_early_stop_absolute_floor_reports_the_frozen_tail():
    """``ent_floor`` overrides the relative floor. Above the first batch's
    entropy it freezes that batch at its first step: both steps report the
    entropy of the unchanged params, each under its own dropout draw (the
    frozen tail). The second batch, with no floor given, adapts on the
    relative one."""
    cfg = tta_config(steps=2, lr=1.0, episodic=False, entropy_focus="uncertain",
                     early_stop={"enabled": True, "entropy_floor_ratio": 0.1},
                     modality_dropout={"enabled": True, "prob": 0.9})
    j, t = _compare(cfg, volumes(2, seed=9), mode="post", params_seed=9, floors=[10.0, None])
    first = j[1][0]
    assert first[0] != first[1]  # two draws over the same frozen params


def test_stochastic_restore_continual():
    cfg = tta_config(steps=2, lr=5e-2, episodic=False, restore={"enabled": True, "prob": 0.3})
    j, t = _compare(cfg, volumes(2, seed=10), mode="post", params_seed=10)
    source = unet3d_from_flax(dryrun_params(10))
    snapped = sum(int((t[0][n] == source[n]).sum()) for n in NORM)
    assert snapped > 0  # some elements sit exactly at their source value


def test_reliability_gating_weights_and_step():
    params = dryrun_params(11)
    x = volumes(1, seed=11)[0]
    logits = torch.from_numpy(np.random.RandomState(11).randn(3, 4, 4, 4, 1).astype(np.float32) * 2)
    from multimodal_tta_tpu.tta.tent import reliability_weights as jax_rel

    for margin in (0.2, 0.6, 0.9):
        got = reliability_weights(logits, sigmoid=True, margin_ratio=margin).numpy()
        want = np.asarray(jax_rel(jnp.asarray(logits.numpy()), sigmoid=True, margin_ratio=margin))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    cfg = tta_config(steps=2, lr=5e-2, entropy_focus="uncertain", reliability={"enabled": True,
                                                                              "margin_ratio": 0.95})
    _compare(cfg, [x], mode="post", params_seed=11)


def test_fisher_over_more_batches_than_its_window_then_cached():
    """Fisher from the first 2 of 3 batches (normalized to mean 1), the
    proximal anchor on every step; a second ``make_adapt_fn`` reuses the
    cached estimate, as the reference's adapter does."""
    params = dryrun_params(12)
    cfg = tta_config(steps=2, lr=5e-2, episodic=False, entropy_focus="uncertain",
                     fisher={"enabled": True, "lambda": 50.0, "batches": 2})
    batches = volumes(3, seed=12)
    j = run_jax_adapter(JaxTentAdapter, params, cfg, batches, 2, None)
    t = run_torch_adapter(TentAdapter, params, cfg, batches, 2, None)
    source = unet3d_from_flax(params)
    assert_adapted_close(t[0], j[0], source, NORM)
    for a, b in zip(t[1], j[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    jad, tad = j[3], t[3]
    assert tad._fisher_n == jad._fisher_n == 2 and tad._fisher_cached is not None
    jf = {"/".join(str(k.key) for k in p): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(jad._fisher_cached)[0]}
    from multimodal_tta_tpu_torch.models.convert import flax_path

    tf = {flax_path(n): f.numpy() for n, f in zip(tad._names, tad._fisher_cached)}
    assert tf.keys() == jf.keys() and len(tf) == 36
    got, want = np.concatenate([tf[k].ravel() for k in sorted(tf)]), np.concatenate([jf[k].ravel() for k in sorted(jf)])
    assert abs(got.mean() - 1.0) < 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))

    # a second run from the source with the cached estimate (the port's model
    # is restored first; the reference starts from its source state)
    state = jax_state(params)
    jfn = jad.make_adapt_fn(state)
    cur = jfn(state, jnp.asarray(batches[0]), 2)
    tad.restore()
    model = tad._model
    tfn = tad.make_adapt_fn(model)
    tfn(model, torch.from_numpy(batches[0]), 2)
    j2 = unet3d_from_flax(jax.tree_util.tree_map(np.asarray, cur.params))
    t2 = {k: v.detach() for k, v in model.state_dict().items()}
    assert_adapted_close(t2, j2, source, NORM)
    assert tad._fisher_n == 2


def test_reset_optimizer_drops_momentum_and_keeps_params():
    params = dryrun_params(13)
    cfg = tta_config(steps=1, lr=5e-2, episodic=False)
    batches = volumes(3, seed=13)
    state = jax_state(params)
    jad = JaxTentAdapter(JaxConfigNode(cfg).tta, config=JaxConfigNode(cfg), mesh=None,
                         device_transform=DEVICE_TRANSFORM)
    jfn = jad.make_adapt_fn(state)
    model = load_flax(UNet3D(**DRYRUN, device="cpu"), params)
    tad = TentAdapter(ConfigNode(cfg).tta, config=ConfigNode(cfg), device_transform=DEVICE_TRANSFORM,
                      device="cpu")
    tfn = tad.make_adapt_fn(model)
    cur = state
    for i, x in enumerate(batches):
        if i == 2:
            jad.reset_optimizer()
            tad.reset_optimizer()
            assert not tad._opt.state
        cur = jfn(cur, jnp.asarray(x), 2)
        tfn(model, torch.from_numpy(x), 2)
    got = {k: v.detach() for k, v in model.state_dict().items()}
    assert_adapted_close(got, unet3d_from_flax(jax.tree_util.tree_map(np.asarray, cur.params)),
                         unet3d_from_flax(params), NORM)


@pytest.mark.parametrize("focus", ["all", "uncertain"])
def test_forward_predict_fn_matches_and_changes_nothing(focus):
    params = dryrun_params(14)
    cfg = tta_config(entropy_focus=focus, episodic=False)
    x = volumes(1, seed=14)[0]
    jad = JaxTentAdapter(JaxConfigNode(cfg).tta, config=JaxConfigNode(cfg), mesh=None,
                         device_transform=DEVICE_TRANSFORM)
    state = jax_state(params)
    jpred, jobj, jgate = jad.make_forward_predict_fn(state, THRESHOLD)(state, jnp.asarray(x), 1)
    model = load_flax(UNet3D(**DRYRUN, device="cpu"), params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tad = TentAdapter(ConfigNode(cfg).tta, config=ConfigNode(cfg), device_transform=DEVICE_TRANSFORM,
                      device="cpu")
    tad.make_adapt_predict_fn(model, THRESHOLD)
    tpred, tobj, tgate = tad.make_forward_predict_fn(model, THRESHOLD)(model, torch.from_numpy(x), 1)
    assert isinstance(tobj, float) and isinstance(tgate, float)
    np.testing.assert_allclose([tobj, tgate], [jobj, jgate], rtol=1e-5)
    if focus == "all":
        assert tobj == tgate
    assert (tpred.numpy() == np.asarray(jpred)).mean() >= 0.999
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("mode", ["inline", "post"])
def test_inline_vs_post_with_every_step_draw(mode):
    """Dropout, consistency and restore together, continual over two
    batches; inline: the served (last) step sees the clean batch."""
    cfg = tta_config(steps=2, lr=2e-2, episodic=False, loss="entropy+consistency",
                     modality_dropout={"enabled": True, "prob": 0.4},
                     restore={"enabled": True, "prob": 0.2})
    _compare(cfg, volumes(2, seed=15), mode=mode, params_seed=15)


def test_window_draws_and_crops():
    g = torch.Generator().manual_seed(0)
    c = window_draws(50, 2, (16, 32, 20), (16, 8, 20), g)
    assert c.shape == (50, 4) and c.dtype == torch.int64
    assert set(c[:, 0].tolist()) == {0, 1} and set(c[:, 1].tolist()) == {0}
    assert 0 <= int(c[:, 2].min()) and int(c[:, 2].max()) <= 24 and set(c[:, 3].tolist()) == {0}
    x = torch.arange(2 * 16 * 32 * 20 * 2, dtype=torch.float32).reshape(2, 16, 32, 20, 2)
    w = apply_crop_windows(x, c[:3], (16, 8, 20))
    assert w.shape == (3, 16, 8, 20, 2)
    for i in range(3):
        s, d, h, ww = c[i].tolist()
        assert torch.equal(w[i], x[s, d:d + 16, h:h + 8, ww:ww + 20])
    assert window_draws(3, 0, (16, 16, 16), (16, 16, 16), g)[:, 0].tolist() == [0, 0, 0]


def test_generator_persists_across_make_and_restore():
    cfg = tta_config(steps=1, modality_dropout={"enabled": True})
    tad = TentAdapter(ConfigNode(cfg).tta, config=ConfigNode(cfg), device="cpu")
    want = torch.Generator().manual_seed(TTA_SEED_PLUS).get_state()
    assert torch.equal(tad.generator.get_state(), want)
    model = UNet3D(**DRYRUN, device="cpu")
    fn = tad.make_adapt_fn(model)
    fn(model, torch.zeros(2, 16, 16, 16, 2), 2)
    state = tad.generator.get_state()
    tad.restore()
    tad.make_adapt_fn(model)
    assert torch.equal(tad.generator.get_state(), state) and not torch.equal(state, want)


TTA_SEED_PLUS = 777  # task.seed 0 + 777, the reference's PRNGKey seed
