"""The port's serving artifact (multimodal_tta_tpu_torch/serving/) on the CPU.

Each TTA method's pure adapt+segment step is exported, saved, loaded and
called over 3 batches, started from the JAX adapter's own
``serving_export_spec`` state (carried across by
``models/convert.py:serving_state_from_flax``) and given the reference's
draws (``tests/_torch_port.py:JaxDraws``), then held:

  - against the JAX ``serving_export_spec`` call, leaf by leaf with
    ROADMAP.md's tolerances: the adapted tensors' deltas from source (and
    the optimizer state, the teacher) within 1e-3 relative L2, the other
    params bitwise, entropies within 1e-5 relative (1e-4 for the
    pseudo-label objective), predictions on 99.9% of voxels;
  - against the port's own live step on the same draws within 1e-6 (on
    the CPU the replayed program runs the same operators in the same
    order).

Also: the forward artifact against ``_probs_fn``, the artifact file's
error cases, what ``load_artifact`` imports, the four kernel operators
under ``torch.library.opcheck``, and the dispatch watchdog (the cases of
tests/test_watchdog.py).
"""

import copy
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu.serving import load_artifact as jax_load_artifact
from multimodal_tta_tpu.tta import cotta as jax_cotta, eata as jax_eata, memo as jax_memo, pl as jax_pl
from multimodal_tta_tpu.tta import sar as jax_sar, tent as jax_tent
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.evaluation.seg_eval import SegmentationEvaluationStrategy
from multimodal_tta_tpu_torch.kernels import edt_minplus
from multimodal_tta_tpu_torch.models.convert import serving_state_from_flax, variables_from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.ops.augment import flatten_draws, group_draws, make_draws
from multimodal_tta_tpu_torch.serving import (
    export_adapt_serving,
    export_forward_serving,
    load_artifact,
    save_artifact,
)
from multimodal_tta_tpu_torch.serving.export import MAGIC
from multimodal_tta_tpu_torch.tta import (
    CottaAdapter,
    EataAdapter,
    MemoAdapter,
    NormAdapter,
    PseudoLabelAdapter,
    SarAdapter,
    TentAdapter,
)
from multimodal_tta_tpu_torch.utils.watchdog import DispatchWatchdog, wedged_diagnosis

from _torch_port import (
    DEVICE_TRANSFORM,
    JaxDraws,
    assert_stats_close,
    bn_unet_variables,
    jax_state,
    np_params,
    randomize,
    tta_config,
    volumes,
)

torch.set_num_threads(2)
# the module (the package's ``fused_instance_norm`` is its wrapper function)
norm_mod = sys.modules["multimodal_tta_tpu_torch.kernels.fused_instance_norm"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESHOLD = 0.3
MODEL = dict(in_channels=2, num_classes=1, channels=(4, 8), strides=(2,), num_res_units=1)
SHAPE = (2, 16, 16, 16, 2)
BN_SHAPE = (2, 8, 16, 16, 2)  # 64+ values per channel at every BatchNorm (tests/_torch_port.py)
N_BATCHES = 3


def _params(seed):
    x0 = np.zeros((1, *SHAPE[1:]), np.float32)
    return randomize(np_params(JaxUNet3D(**MODEL), x0, train=False), seed)


# (port class, JAX class, config overrides, predict mode, entropy rtol)
CASES = {
    "tent_continual_inline": (TentAdapter, jax_tent.TentAdapter, dict(steps=2, episodic=False), "inline", 1e-5),
    "tent_episodic_post": (TentAdapter, jax_tent.TentAdapter, dict(steps=1), "post", 1e-5),
    "tent_dropout_restore_early_stop": (
        TentAdapter, jax_tent.TentAdapter,
        dict(steps=2, episodic=False, modality_dropout={"enabled": True, "prob": 0.4},
             restore={"enabled": True, "prob": 0.2},
             early_stop={"enabled": True, "entropy_floor_ratio": 0.999}), "post", 1e-5),
    "pl": (PseudoLabelAdapter, jax_pl.PseudoLabelAdapter,
           dict(steps=1, episodic=False, pl={"conf_threshold": 0.6}), "inline", 1e-4),
    "eata_reliability": (EataAdapter, jax_eata.EataAdapter,
                         dict(steps=1, episodic=False, reliability={"enabled": True, "margin_ratio": 1.0},
                              fisher={"enabled": False}), "inline", 1e-5),
    "sar": (SarAdapter, jax_sar.SarAdapter, dict(steps=1, episodic=False, margin_ratio=1.0), "inline", 1e-5),
    "cotta": (CottaAdapter, jax_cotta.CottaAdapter,
              dict(steps=1, episodic=False, n_views=2, restore={"enabled": True, "prob": 0.1}), "post", 1e-5),
    "memo": (MemoAdapter, jax_memo.MemoAdapter, dict(steps=1, n_views=2), "inline", 1e-5),
}


def _export(ad, model, shape, mode, tmp_path):
    program, meta, _ = export_adapt_serving(ad, model, shape, threshold=THRESHOLD, predict_mode=mode, device="cpu")
    path = os.path.join(tmp_path, "art.mttap")
    save_artifact(path, program, meta, _)
    return load_artifact(path, device="cpu"), meta


def _run_case(tmp_path, port_cls, jax_cls, cfg_dict, mode, *, params, batch_stats=None, jmodule, model,
              shape, n_batches=N_BATCHES):
    cfg = ConfigNode(cfg_dict)
    from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode

    jcfg = JaxConfigNode(cfg_dict)
    # the JAX package's pure step and its state
    jad = jax_cls(jcfg.tta, config=jcfg, mesh=None, device_transform=DEVICE_TRANSFORM)
    jstate = jax_state(params, module=jmodule, batch_stats=batch_stats)
    jcall, jst0 = jad.serving_export_spec(jstate, THRESHOLD, mode)
    jcall = jax.jit(jcall)
    # the port's artifact, started from the JAX state
    ad = port_cls(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device="cpu")
    art, meta = _export(ad, model, shape, mode, tmp_path)
    names = [a["name"] for a in meta["args"][:art.n_state]]

    def port_state(jst):
        host = jax.tree_util.tree_map(np.asarray, jst)
        return serving_state_from_flax(names, host[0], host[1], host[2], host[3:])

    st0 = port_state(jst0)
    own0 = art.initial_state()
    assert all(torch.equal(a, b) or (a.isnan().all() and b.isnan().all()) for a, b in zip(st0, own0))
    # the port's live step on the same weights and draws
    live = port_cls(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device="cpu")
    live_model = copy.deepcopy(model)
    fn = live.make_adapt_predict_fn(live_model, THRESHOLD, mode)
    jd = JaxDraws(ad, params)
    rng = jax.random.PRNGKey(0 + 777)
    jst, st = jst0, st0
    for i, x in enumerate(volumes(n_batches, seed=31, shape=shape)):
        rng, key = jax.random.split(rng)
        draws = jd(shape, shape[0], post=ad.serving_post(mode))
        episodic = meta["episodic"]
        jst, jents, jpred = jcall(jst0 if episodic else jst, jnp.asarray(x), key, jnp.int32(shape[0]),
                                  jnp.float32(jnp.nan))
        out = art.call(*(st0 if episodic else st), torch.from_numpy(x),
                       *flatten_draws(meta["draws"], draws), shape[0], float("nan"))
        st, ents, pred = list(out[:art.n_state]), out[art.n_state], out[art.n_state + 1]
        live.batch_draws = lambda *a, _d=draws, **k: _d
        _, live_pred = fn(live_model, torch.from_numpy(x), shape[0])
        # the port's live step within 1e-6
        assert torch.allclose(ents, live._last_ents, rtol=0.0, atol=1e-6)
        assert torch.equal(pred, live_pred)
        live_params = dict(live_model.named_parameters())
        for n, t in zip(names, st):
            if n.startswith("param:"):
                assert torch.allclose(t, live_params[n[6:]].detach(), rtol=0.0, atol=1e-6), n
        yield i, jst, np.asarray(jents), np.asarray(jpred), st, ents, pred, port_state, names, ad


def _check_against_jax(run, ent_rtol, source):
    for i, jst, jents, jpred, st, ents, pred, port_state, names, ad in run:
        np.testing.assert_allclose(ents.numpy(), jents, rtol=ent_rtol)
        assert pred.dtype == torch.uint8 and pred.shape == jpred.shape
        assert (pred.numpy() == jpred).mean() >= 0.999
    want = dict(zip(names, port_state(jst)))
    got = dict(zip(names, st))
    adapted = {f"param:{n}" for n in ad._names}
    for n in names:
        if n.startswith("param:") and n not in adapted:
            assert torch.equal(got[n], want[n]), n
    # the adapted params as deltas from source; the optimizer state and the
    # teacher as they are (an EMA of 0.999 keeps the teacher's deltas at the
    # rounding level of its values)
    for prefix, ref in (("param:", source), ("opt:", {}), ("teacher:", {})):
        keys = [n for n in names if n.startswith(prefix) and (prefix != "param:" or n in adapted)
                and n != "opt:count"]
        if not keys:
            continue
        dj = torch.cat([(want[n] - ref.get(n[6:], 0)).flatten() for n in keys])
        dt = torch.cat([(got[n] - ref.get(n[6:], 0)).flatten() for n in keys])
        assert float(dj.norm()) > 0, prefix
        assert float((dt - dj).norm() / dj.norm()) < 1e-3, (prefix, float((dt - dj).norm() / dj.norm()))
    assert_stats_close({n: got[n] for n in names if n.startswith("stat:")},
                       {n: want[n] for n in names if n.startswith("stat:")})
    for n in names:
        if n in ("em", "opt:count"):
            assert torch.allclose(got[n], want[n], rtol=1e-5, atol=1e-6, equal_nan=True), n


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_matches_the_jax_artifact_and_the_live_step(case, tmp_path):
    port_cls, jax_cls, kw, mode, ent_rtol = CASES[case]
    method = port_cls.method
    cfg_dict = tta_config(method, lr=5e-2, **kw)
    params = _params(seed=len(case))
    model = UNet3D(**MODEL, device="cpu", seed=None)
    model.load_state_dict(variables_from_flax({"params": params}), strict=True)
    source = {k: v.detach().clone() for k, v in model.named_parameters()}
    run = _run_case(tmp_path, port_cls, jax_cls, cfg_dict, mode, params=params, jmodule=JaxUNet3D(**MODEL),
                    model=model, shape=SHAPE)
    _check_against_jax(run, ent_rtol, source)


def test_batchnorm_unet_tent_artifact(tmp_path):
    """A BATCH UNet3D: the running statistics ride in the state and come
    back moved once per step, as the reference's ``mutable=["batch_stats"]``."""
    variables = bn_unet_variables(seed=4, cfg=MODEL, shape=BN_SHAPE[1:])
    model = UNet3D(**MODEL, norm="BATCH", device="cpu", seed=None)
    model.load_state_dict(variables_from_flax(variables), strict=True)
    source = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats0 = {k: v.clone() for k, v in model.named_buffers()}
    cfg_dict = tta_config("tent", lr=5e-2, steps=1, episodic=False)
    run = _run_case(tmp_path, TentAdapter, jax_tent.TentAdapter, cfg_dict, "post", params=variables["params"],
                    batch_stats=variables["batch_stats"], jmodule=JaxUNet3D(**MODEL, norm="BATCH"),
                    model=model, shape=BN_SHAPE)
    _check_against_jax(run, 1e-5, source)
    # the exported model's own buffers were never written
    assert all(torch.equal(v, stats0[k]) for k, v in model.named_buffers())


def test_forward_artifact_matches_probs_fn(tmp_path):
    model = UNet3D(**MODEL, device="cpu", seed=3)
    strat = SegmentationEvaluationStrategy(ConfigNode({}))

    def probs(image):
        return strat._probs_fn(model)(image)[1]

    program, meta = export_forward_serving(probs, SHAPE, device="cpu")
    path = os.path.join(tmp_path, "fwd.mttap")
    save_artifact(path, program, meta)
    art = load_artifact(path, device="cpu")
    assert art.meta["mode"] == "forward" and art.n_state == 0 and art.initial_state() == []
    x = torch.from_numpy(volumes(1, seed=5, shape=SHAPE)[0])
    with torch.no_grad():
        want = probs(x)
    assert torch.allclose(art.call(x), want, rtol=0.0, atol=1e-6)


def test_draws_of_the_artifact_are_the_live_adapters(tmp_path):
    """``ServingArtifact.draws`` (``make_draws`` of the recorded spec) takes
    the generator's numbers in the order the live adapter's ``batch_draws``
    does, and ``flatten_draws`` / ``group_draws`` are inverses."""
    cfg = ConfigNode(tta_config("cotta", steps=2, n_views=3, restore={"enabled": True, "prob": 0.3},
                                modality_dropout={"enabled": True}))
    ad = CottaAdapter(cfg.tta, config=cfg, device="cpu")
    ad._bind(UNet3D(**MODEL, device="cpu", seed=1))
    spec = ad.batch_draw_spec(SHAPE, post=True)
    got = make_draws(spec, torch.Generator().manual_seed(9), 2)
    ad.generator.manual_seed(9)
    batch = ad.batch_draws(SHAPE, 2, post=True)
    want = flatten_draws(spec, batch)
    # per step: 2 views of 3 tensors, 6 restore masks, the dropout mask; then the post views
    assert len(got) == len(want) == 2 * (2 * 3 + 6 + 1) + 2 * 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    regrouped = group_draws(spec, want)
    assert all(torch.equal(a, b) for a, b in zip(flatten_draws(spec, regrouped), want))
    assert regrouped["steps"][0]["windows"] is None and len(regrouped["post"]) == 2


def test_artifact_errors(tmp_path):
    cfg = ConfigNode(tta_config("eata", fisher={"enabled": True}))
    eata = EataAdapter(cfg.tta, config=cfg, device="cpu")
    model = UNet3D(**MODEL, device="cpu", seed=1)
    with pytest.raises(ValueError, match="Fisher anchor"):
        export_adapt_serving(eata, model, SHAPE, threshold=0.5, device="cpu")
    with pytest.raises(ValueError, match="serving_export_spec protocol"):
        export_adapt_serving(NormAdapter(ConfigNode({}), device="cpu"), model, SHAPE, threshold=0.5, device="cpu")
    # a file of neither package, the JAX package's file, the port's file for the JAX loader
    bad = os.path.join(tmp_path, "bad.mttap")
    with open(bad, "wb") as f:
        f.write(b"NOTANART" + b"\0" * 32)
    with pytest.raises(ValueError, match="not a serving artifact"):
        load_artifact(bad, device="cpu")
    from multimodal_tta_tpu.serving import export_forward_serving as jax_export_forward
    from multimodal_tta_tpu.serving import save_artifact as jax_save

    exported, jmeta = jax_export_forward(lambda x: x * 2.0, (1, 2), platforms=("cpu",))
    jpath = os.path.join(tmp_path, "jax.mttas")
    jax_save(jpath, exported, jmeta)
    with pytest.raises(ValueError, match="not a serving artifact"):
        load_artifact(jpath, device="cpu")
    program, meta = export_forward_serving(lambda x: x * 2.0, (1, 2), device="cpu")
    path = os.path.join(tmp_path, "port.mttap")
    save_artifact(path, program, meta)
    with pytest.raises(ValueError, match="not a serving artifact"):
        jax_load_artifact(path)
    # one device per artifact: a file that records another device, a tensor on another device
    raw = open(path, "rb").read()
    hlen = int.from_bytes(raw[8:12], "little")
    header = raw[12:12 + hlen].replace(b'"device": "cpu"', b'"device": "cuda:0"')
    other = os.path.join(tmp_path, "other.mttap")
    with open(other, "wb") as f:
        f.write(MAGIC + len(header).to_bytes(4, "little") + header + raw[12 + hlen:])
    with pytest.raises(ValueError, match="traced on cuda:0"):
        load_artifact(other, device="cpu")
    art = load_artifact(path, device="cpu")
    with pytest.raises(ValueError, match="runs on cpu"):
        art.call(torch.zeros(1, 2, device="meta"))
    assert torch.equal(art.call(torch.ones(1, 2)), torch.full((1, 2), 2.0))


def test_load_artifact_imports_no_model_config_or_core_code(tmp_path):
    program, meta = export_forward_serving(lambda x: x + 1.0, (1, 2), device="cpu")
    path = os.path.join(tmp_path, "plus.mttap")
    save_artifact(path, program, meta)
    code = ("import sys, torch\n"
            "from multimodal_tta_tpu_torch.serving import load_artifact\n"
            f"art = load_artifact({path!r}, device='cpu')\n"
            "assert torch.equal(art.call(torch.zeros(1, 2)), torch.ones(1, 2))\n"
            "print(' '.join(sorted(m for m in sys.modules if m.startswith('multimodal_tta_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=REPO_ROOT, check=True).stdout.split()
    assert "multimodal_tta_tpu_torch.kernels.fused_instance_norm" in out
    assert not [m for m in out if m.split(".")[1:2] in (["models"], ["conf"], ["core"])
                or m.split(".")[0] == "multimodal_tta_tpu"], out


def _norm_args(need_grad=False):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 4, 5, 8, generator=g, requires_grad=need_grad)
    gamma = (torch.rand(8, generator=g) + 0.5).requires_grad_(need_grad)
    beta = torch.randn(8, generator=g).requires_grad_(need_grad)
    return x, gamma, beta


@pytest.mark.parametrize("op", ["norm_forward", "norm_backward", "minplus", "squared_edt_volumes"])
def test_kernel_operators_pass_opcheck(op):
    """``torch.library.opcheck`` on the CPU: schema, fake implementation,
    autograd registration (the norm forward, with and without gradients)."""
    x, gamma, beta = _norm_args()
    if op == "norm_forward":
        for need_grad in (False, True):
            torch.library.opcheck(norm_mod._forward_op, (*_norm_args(need_grad), 1e-5, True))
        torch.library.opcheck(norm_mod._forward_op, (x, gamma, beta, 1e-5, False))
    elif op == "norm_backward":
        y, stats = norm_mod.instance_norm_forward(x, gamma, beta)
        for need_dx in (True, False):
            torch.library.opcheck(norm_mod._backward_op, (torch.randn_like(y), x, gamma, beta, stats, True, need_dx))
    elif op == "minplus":
        f = torch.rand(6, 7) * 10
        f[1] = float("inf")
        torch.library.opcheck(edt_minplus._minplus_op, (f, edt_minplus.edt_cost_matrix(7, 1.5)))
    else:
        pts = torch.rand(2, 3, 4, 5) > 0.7
        torch.library.opcheck(edt_minplus._edt_op, (pts, [3.0, 1.0, 1.5], True))


# ---- the dispatch watchdog (tests/test_watchdog.py:30-86) -------------------
def test_watchdog_fires_on_hung_callable():
    fired = threading.Event()
    with DispatchWatchdog(0.15, what="mock hang", on_timeout=fired.set, poll_s=0.02):
        fired.wait(timeout=5.0)
    assert fired.is_set()


def test_watchdog_heartbeat_resets_deadline():
    fired = threading.Event()
    with DispatchWatchdog(0.3, what="hb", on_timeout=fired.set, poll_s=0.02) as wd:
        for _ in range(5):
            time.sleep(0.1)
            wd.heartbeat()
    assert not fired.is_set()


def test_watchdog_clean_exit_disarms():
    fired = threading.Event()
    with DispatchWatchdog(0.2, what="fast", on_timeout=fired.set, poll_s=0.02):
        pass
    time.sleep(0.4)
    assert not fired.is_set()


@pytest.mark.parametrize("deadline", [None, 0, -1.0])
def test_watchdog_disabled(deadline):
    fired = threading.Event()
    with DispatchWatchdog(deadline, on_timeout=fired.set) as wd:
        assert not wd.enabled
        time.sleep(0.1)
    assert not fired.is_set()


def test_watchdog_exception_propagates_and_disarms():
    fired = threading.Event()
    with pytest.raises(RuntimeError):
        with DispatchWatchdog(0.2, on_timeout=fired.set, poll_s=0.02):
            raise RuntimeError("boom")
    time.sleep(0.4)
    assert not fired.is_set()


def test_watchdog_diagnosis_names_the_failure():
    msg = wedged_diagnosis("adapt dispatch", 60.0)
    assert "adapt dispatch" in msg
    assert "stale" in msg and "kill" in msg.lower() and "nvidia-smi" in msg


def test_watchdog_first_deadline_holds_until_the_first_heartbeat():
    """The first section gets ``first_deadline_s``; ``touch`` keeps it, a
    heartbeat ends it."""
    fired = threading.Event()
    with DispatchWatchdog(0.15, on_timeout=fired.set, poll_s=0.02, first_deadline_s=5.0) as wd:
        time.sleep(0.3)
        wd.touch()
        time.sleep(0.3)
        assert not fired.is_set()
        wd.heartbeat()
        fired.wait(timeout=5.0)
    assert fired.is_set()


def test_build_serving_step_is_the_pure_call_over_one_flat_tuple():
    """``build_serving_step`` (the reference's name) runs the pure step
    eagerly over ``(*state, image, *draws, n_valid, ent_floor)``: equal to the
    live step, and the model it was built from keeps its values."""
    cfg = ConfigNode(tta_config("tent", lr=5e-2, steps=2, episodic=False))
    model = UNet3D(**MODEL, device="cpu", seed=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ad = TentAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device="cpu")
    step, state0 = ad.build_serving_step(model, THRESHOLD, "inline")
    live_model = copy.deepcopy(model)
    live = TentAdapter(cfg.tta, config=cfg, device_transform=DEVICE_TRANSFORM, device="cpu")
    fn = live.make_adapt_predict_fn(live_model, THRESHOLD, "inline")
    x = torch.from_numpy(volumes(1, seed=9, shape=SHAPE)[0])
    out = step(*state0, x, torch.tensor(2, dtype=torch.int32), torch.tensor(float("nan")))
    _, pred = fn(live_model, x, 2)
    assert torch.equal(out[-1], pred) and torch.equal(out[-2], live._last_ents)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
