"""The streaming protocol of the port (multimodal_tta_tpu_torch/tta/stream.py:
``StreamTTAController``, ``binary_dice_per_case``, ``evaluate_stream``) and
the stream mode of ``cli.adapt``, against the JAX package's on the same
weights and stream: the reset policies, the entropy watchdog (with the
stream-anchored early-stop floor), the periodic re-anchor, the entropy
gate (escalation that re-serves the batch adapted, the drop back to forward
mode at a re-anchor), ``from_config`` (errors, the ``reprobe_every`` alias,
the warning); every stock ``configs/tta/*.yaml`` through the port's
``cli.adapt``.

Tolerances: the metric dicts key for key; strings, counts, modes and
re-anchor flags equal; Dice (rounded to 4 places by both) within 2e-4 and
entropies (rounded to 5 places) within 1e-4 relative plus 1e-5 — f32
forwards that agree to about 1e-5, rounded once more.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.conf import compose as jax_compose
from multimodal_tta_tpu.core import ExperimentManager as JaxExperimentManager
from multimodal_tta_tpu.tta import TTAEngine as JaxTTAEngine
from multimodal_tta_tpu.tta.stream import StreamTTAController as JaxStream
from multimodal_tta_tpu.tta.stream import binary_dice_per_case as jax_dice
from multimodal_tta_tpu.tta.stream import evaluate_stream as jax_evaluate_stream
from multimodal_tta_tpu.tta.tent import TentAdapter as JaxTentAdapter
from multimodal_tta_tpu_torch.cli import CONFIG_DIR, adapt
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from multimodal_tta_tpu_torch.tta import TentAdapter
from multimodal_tta_tpu_torch.tta.stream import StreamTTAController, binary_dice_per_case, evaluate_stream
from tests._torch_port import (DEVICE_TRANSFORM, DRYRUN, NormCalls, dryrun_params, jax_state, load_flax, tta_config,
                               volumes)
from tests.test_torch_cli import common, env, jax_weights  # noqa: F401 (module fixtures)

torch.set_num_threads(2)

THRESHOLD = 0.3


@pytest.fixture(autouse=True)
def _restore_cwd():
    """A CLI run moves into its run directory (hydra.job.chdir: true)."""
    cwd = os.getcwd()
    yield
    os.chdir(cwd)


def same_metrics(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if k == "positions" or k == "gate/escalations":
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                same_metrics(a, b)
        elif isinstance(w, float) and not isinstance(w, bool):
            tol = 2e-4 if ("dc" in k or k == "dice") else 1e-4 * abs(w) + 1e-5
            assert math.isclose(g, w, rel_tol=0.0, abs_tol=tol), (k, g, w)
        elif k == "dice" and w is not None:
            assert math.isclose(g, w, abs_tol=2e-4), (k, g, w)
        else:
            assert g == w, (k, g, w)


def _stream(order, seed=0):
    """(domain, batch) pairs of two [16,16,16] volumes with sparse labels."""
    rng = np.random.RandomState(seed)
    xs = volumes(len(order), seed=seed)
    return [(dom, {"image": x, "label": (rng.rand(2, 16, 16, 16, 1) > 0.8).astype(np.float32), "_n_valid": 2})
            for dom, x in zip(order, xs)]


def _both(cfg, stream, seed=0, **kw):
    """evaluate_stream of the JAX and the port controller built by
    ``from_config`` (or with ``kw``) on the same weights."""
    params = dryrun_params(seed)
    jcfg, tcfg = JaxConfigNode(cfg), ConfigNode(cfg)
    state = jax_state(params)
    jad = JaxTentAdapter(jcfg.tta, config=jcfg, mesh=None, device_transform=DEVICE_TRANSFORM)
    model = load_flax(UNet3D(**DRYRUN, device="cpu"), params)
    source = {k: v.clone() for k, v in model.state_dict().items()}
    tad = TentAdapter(tcfg.tta, config=tcfg, device_transform=DEVICE_TRANSFORM, device="cpu")
    if kw:
        jc = JaxStream(jad, state, threshold=THRESHOLD, **kw)
        tc = StreamTTAController(tad, model, threshold=THRESHOLD, **kw)
    else:
        jc = JaxStream.from_config(jad, state, jcfg, threshold=THRESHOLD)
        tc = StreamTTAController.from_config(tad, model, tcfg, threshold=THRESHOLD)
    want = jax_evaluate_stream(jc, stream)
    got = evaluate_stream(tc, stream)
    same_metrics(got, want)
    return got, tc, model, source


@pytest.mark.parametrize("policy", ["episodic", "continual", "reset_on_domain_change"])
def test_policies_match(policy):
    cfg = tta_config(steps=1, lr=5e-2, episodic=False, entropy_focus="uncertain",
                     stream={"policy": policy, "guard": False})
    got, tc, model, source = _both(cfg, _stream(["A", "A", "B", "B"], seed=1), seed=1)
    assert got["policy"] == policy and got["n_cases"] >= 1
    assert got["reanchors"] == (1 if policy == "reset_on_domain_change" else 0)
    tc.reanchor("test")
    assert all(torch.equal(v, source[k]) for k, v in model.state_dict().items())


def test_guard_reanchors_and_anchors_the_early_stop_floor():
    """The watchdog at 0.995 of the stream's first entropy fires under a
    steep lr; the adapter's early stop gets the stream-anchored floor."""
    cfg = tta_config(steps=2, lr=3.0, episodic=False, entropy_focus="uncertain",
                     early_stop={"enabled": True, "entropy_floor_ratio": 0.5},
                     stream={"policy": "continual", "guard": True, "entropy_floor_ratio": 0.995})
    got, tc, _, _ = _both(cfg, _stream(["A", "A", "A"], seed=2), seed=2)
    assert got["reanchors"] >= 1 and got["policy"] == "continual+guard"
    assert tc.reanchor_log[0][1].startswith("entropy watchdog")


def test_periodic_reanchor():
    cfg = tta_config(steps=1, lr=5e-2, episodic=False, stream={"periodic_reanchor_every": 2, "guard": False})
    got, _, _, _ = _both(cfg, _stream(["A"] * 4, seed=3), seed=3)
    assert got["reanchors"] == 2
    assert [p["reanchored"] for p in got["positions"]] == [False, True, False, True]


def test_gate_escalates_reserves_and_drops_back():
    """Forward mode until the plain entropy crosses the threshold; the
    crossing batch is re-served adapted; the periodic re-anchor drops back
    to forward mode, where the next batch is probed at source."""
    params = dryrun_params(4)
    cands = _stream(["A"] * 6, seed=4)
    cfg = tta_config(steps=1, lr=5e-2, episodic=False)
    model = load_flax(UNet3D(**DRYRUN, device="cpu"), params)
    ad = TentAdapter(ConfigNode(cfg).tta, config=ConfigNode(cfg), device_transform=DEVICE_TRANSFORM, device="cpu")
    fp = ad.make_forward_predict_fn(model, THRESHOLD)
    gates = [fp(model, torch.from_numpy(b["image"]), 2)[2] for _, b in cands]
    order = np.argsort(gates)
    lo, hi = int(order[0]), int(order[-1])
    stream = [("A", cands[lo][1]), ("B", cands[hi][1])] + [("B", cands[i][1]) for i in order[1:-1]]
    thr = 0.5 * (gates[lo] + gates[hi])
    got, tc, _, _ = _both(cfg, stream, seed=4, policy="continual", gate=True, gate_threshold=thr,
                          periodic_reanchor_every=2)
    assert got["gate/escalations"][0]["batch"] == 1 and got["positions"][1]["mode"] == "adapt"
    assert got["positions"][0]["mode"] == "forward" and got["positions"][2]["mode"] == "forward"
    assert got["gate/forward_batches"] >= 2 and got["gate/adapt_batches"] >= 1
    assert got["policy"] == "continual+gate" and got["reanchors"] >= 1


def test_binary_dice_per_case_matches():
    rng = np.random.RandomState(5)
    pred = (rng.rand(3, 4, 4, 4, 1) > 0.5).astype(np.uint8)
    label = (rng.rand(3, 4, 4, 4, 1) > 0.6).astype(np.float32)
    label[1] = 0
    got = binary_dice_per_case(torch.from_numpy(pred), label, 3)
    assert got == jax_dice(jnp.asarray(pred), label, 3) and len(got) == 2


def _from_config(stream, **tta):
    cfg = ConfigNode(tta_config(episodic=False, stream=stream, **tta))
    ad = TentAdapter(cfg.tta, config=cfg, device="cpu")
    return StreamTTAController.from_config(ad, UNet3D(**DRYRUN, device="cpu"), cfg, threshold=THRESHOLD)


def test_from_config_errors_alias_and_warning():
    with pytest.raises(ValueError, match="gate.enabled is false"):
        _from_config({"gate": {"reprobe_every": 3}})
    with pytest.raises(ValueError, match="are aliases"):
        _from_config({"periodic_reanchor_every": 2, "gate": {"enabled": True, "reprobe_every": 3}})
    c = _from_config({"gate": {"enabled": True, "reprobe_every": 3}})
    assert c.period == 3 and c.gate and c.mode == "forward"
    with pytest.warns(UserWarning, match="PLAIN volume-mean entropy"):
        c = _from_config({"gate": {"enabled": True, "threshold": 0.2}}, entropy_focus="uncertain")
    assert c.gate_threshold == 0.2
    with pytest.raises(ValueError, match="unknown policy"):
        _from_config({"policy": "sometimes"})
    cfg = ConfigNode(tta_config(episodic=True))
    with pytest.raises(ValueError, match="owns reset policy"):
        StreamTTAController(TentAdapter(cfg.tta, device="cpu"), None, threshold=THRESHOLD)
    from multimodal_tta_tpu_torch.tta import NormAdapter

    norm = NormAdapter(ConfigNode(tta_config("norm", episodic=False)).tta, device="cpu")
    with pytest.raises(ValueError, match="make_adapt_predict_fn"):
        StreamTTAController(norm, None, threshold=THRESHOLD)


# ---- cli.adapt ---------------------------------------------------------------
def _jax_stream_metrics(env, run, extra, params):
    """adapt.py's stream branch (adapt.py:78-113), in process, with the
    given params."""
    cfg = jax_compose(CONFIG_DIR, "config", common(env, run) + list(extra) + [
        "hydra.job.chdir=false", f"hydra.run.dir={env['root']}/jax_{run}"])
    m = JaxExperimentManager(cfg)
    m.setup_model()
    test_loader = m.setup_test_data()
    m.setup_optimizer()
    m.state = m.state.replace(params=params)
    builder = m._builder
    engine = JaxTTAEngine(cfg, mesh=m.mesh, device_transform=builder.build_transform("test").device_spec())
    ctrl = JaxStream.from_config(engine.adapter, m.state, cfg, threshold=float(cfg.evaluation.seg.threshold))
    order = cfg.tta.stream.get("domain_order")
    if order:
        stream = ((dom, b) for dom in order for b in builder.get_loader("test", target_center=str(dom)))
    else:
        stream = ((b.get("domain", ["?"])[0], b) for b in test_loader)
    with m.mesh:
        return jax_evaluate_stream(ctrl, stream)


@pytest.mark.parametrize("extra", [
    ["tta=tent", "tta.episodic=false", "tta.steps=2", "tta.lr=0.5", "tta.stream.enabled=true",
     "tta.stream.policy=reset_on_domain_change", "tta.stream.guard=true", "tta.stream.entropy_floor_ratio=0.9",
     "tta.stream.domain_order=[CHUS,CHUM]"],
    ["tta=eata_gate", "tta.steps=1", "tta.stream.enabled=true", "tta.stream.guard=false",
     "tta.stream.gate.enabled=true", "tta.stream.gate.ratio=1.0", "tta.stream.periodic_reanchor_every=1"],
], ids=["domain_order_guard", "eata_gate_gated"])
def test_adapt_cli_stream_matches_the_reference(env, jax_weights, extra):  # noqa: F811
    run = "stream_" + extra[0].split("=")[1]
    got = adapt.main(common(env, run) + extra + [f"training.resume={jax_weights['checkpoint']}"], device="cpu")
    runs = [d for d in os.listdir(os.path.join(env["root"], "outputs", run))]
    with open(os.path.join(env["root"], "outputs", run, runs[0], "tta_metrics.json"), encoding="utf-8") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert set(got) == {"adapted"}
    want = _jax_stream_metrics(env, run, extra, jax_weights["params"])
    same_metrics(got["adapted"], want)
    if "tta=tent" in extra:
        assert got["adapted"]["reanchors"] >= 1 and "dom/CHUM/avg_dc" in got["adapted"]
    else:
        assert "gate/forward_batches" in got["adapted"]


STOCK = sorted(os.path.splitext(n)[0] for n in os.listdir(os.path.join(CONFIG_DIR, "tta")))


@pytest.mark.parametrize("name", STOCK)
def test_every_stock_tta_config_runs_through_cli_adapt(env, jax_weights, name):  # noqa: F811
    assert len(STOCK) == 11
    got = adapt.main(common(env, f"stock_{name}") + [f"tta={name}", f"training.resume={jax_weights['checkpoint']}"],
                     device="cpu")
    m = got["adapted"]
    assert "gtvt_dc" in m and all(np.isfinite(v) for v in m.values())


# ---- chip_smoke.py's phase 15 at fixture size -------------------------------
def test_chip_smoke_tta_phase_runs_on_the_cpu():
    """Phase 15's method runs on the CPU at fixture size: their checks, and
    the norm calls of each run against ``expected_tta_launches`` (18 norm
    layers, as the flagship's)."""
    import chip_smoke

    model = load_flax(UNet3D(**DRYRUN, device="cpu"), dryrun_params(6))
    rng = np.random.RandomState(6)
    batches = [{"image": x, "label": (rng.rand(2, 16, 16, 16, 1) > 0.8).astype(np.float32), "domain": ["a", "b"]}
               for x in volumes(2, seed=6)]
    calls = NormCalls()
    try:
        out = chip_smoke.tta_phase("cpu", model, batches, extra=["tta.window.roi_size=[16,16,16]"],
                                   reset_counts=calls.reset, read_counts=calls.read)
    finally:
        calls.remove()
    assert list(out) == [tag for tag, _ in chip_smoke.TTA_RUNS] and len(out) == 16
    for tag, r in out.items():
        assert r["launches"] == dict(zip(("forward", "backward"), chip_smoke.expected_tta_launches(
            r["adapter"], r["batches"], r["traces"]))), tag
        assert len(r["ms_per_batch"]) == 2
        if r["adapter"].method == "sar":
            resets = chip_smoke.sar_resets(r["adapter"], r["traces"])
            assert r["source_copies"] == [n + int(r["adapter"].episodic) for n in resets], tag
    assert chip_smoke.sar_resets(out["sar"]["adapter"], out["sar"]["traces"]) == [0, 0]
    assert chip_smoke.sar_resets(out["sar_recovery_reset"]["adapter"], out["sar_recovery_reset"]["traces"]) == [4, 4]
    es = out["tent_consistency_early_stop_dropout"]
    assert [len(t) - chip_smoke.active_steps(es["adapter"], t) for t in es["traces"]] == [1, 0]  # a frozen step
    tail = out["tent_early_stop_frozen_tail"]
    assert [len(t) - chip_smoke.active_steps(tail["adapter"], t) for t in tail["traces"]] == [2, 2]
    assert tail["launches"]["backward"] == 0
    for t in tail["traces"]:  # the frozen params' entropy, flat
        np.testing.assert_allclose(t[1], t[0], rtol=1e-6)
    assert out["norm"]["launches"] == {"forward": 36, "backward": 0}
    assert out["memo"]["launches"] == {"forward": 2 * 18 * (1 + 2 * 2 * 4), "backward": 2 * 18 * 2 * 4}
    assert out["eata"]["launches"]["backward"] == 2 * 18 * (4 + 1)  # 4 steps and the Fisher batch each


def test_chip_smoke_stream_phase_runs_on_the_cpu(env, jax_weights, tmp_path):  # noqa: F811
    """Phase 15's streams through cli.adapt at fixture size (channels 2..32,
    one residual unit), their checks and launch counts."""
    import chip_smoke
    from multimodal_tta_tpu_torch.models.layers import InstanceNorm

    n_norms = sum(isinstance(m, InstanceNorm) for m in UNet3D(
        in_channels=2, num_classes=1, channels=(2, 4, 8, 16, 32), strides=(2, 2, 2, 2), num_res_units=1,
        device="cpu").modules())

    small = ["dataset.expected_shape=[16,16,16]", "training.data.transforms.image_size=[16,16,16]",
             "model.channels=[2,4,8,16,32]", "model.num_res_units=1", "training.compute_dtype=float32",
             "training.eval_batch_size=2", "training.num_workers=0"]
    calls = NormCalls()
    try:
        out = chip_smoke.stream_phase("cpu", env["manifest"], jax_weights["checkpoint"], str(tmp_path), extra=small,
                                      reset_counts=calls.reset, read_counts=calls.read, per_forward=n_norms)
    finally:
        calls.remove()
    assert set(out) == set(chip_smoke.STREAM_RUNS)
    for name, r in out.items():
        assert r["launches"] == r["want"], name
        assert r["batches"] == 4  # two batches of each centre's 3 test cases
    gate = out["stream_eata_gate"]
    assert gate["metrics"]["gate/escalations"] and min(gate["gate_probe"]) < gate["gate_threshold"]
