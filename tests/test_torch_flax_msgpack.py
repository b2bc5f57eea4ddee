"""The reference's msgpack checkpoint format in the port
(``multimodal_tta_tpu_torch/core/flax_msgpack.py``, ``models/convert.py:to_flax``,
``core/optim.py:optax_state`` / ``load_optax_state``, ``core/checkpoint.py``)
against flax and the JAX package, on the CPU at ``tests/_torch_port.py``'s
``SMALL`` widths:

  - the codec writes what ``flax.serialization.msgpack_serialize`` writes,
    byte for byte, and reads flax's bytes: every dtype the reference writes,
    0-d arrays, empty maps, NamedTuple-style maps in field order, every
    size class of the format, chunked arrays (both packages' chunk size
    lowered);
  - for each optimizer case (Adam with weight decay, SGD with momentum and
    weight decay, AdamW, Adafactor with momentum, Adam with ``grad_accum``
    2, Adam with EMA) the JAX package trains and saves with its own
    ``save_checkpoint``; the port restores the file bitwise (params,
    moments, counts, learning rate, EMA shadow against ``from_flax`` of the
    JAX trees) and its next step agrees with the JAX one; the port trains,
    saves, and the JAX package's ``load_checkpoint`` restores every leaf
    bitwise; a JAX file read and written again by the port is the same
    bytes, also for the BatchNorm flagship, UNETR with two MoE experts and
    UNet3D-WS;
  - ``load_params_only`` and the distilled teacher from a ``.msgpack``
    alone; which file loads when ``.msgpack`` and ``.pt`` share a path."""

import io
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core import optim as joptim
from multimodal_tta_tpu.core.checkpoint import load_checkpoint as jax_load_checkpoint
from multimodal_tta_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu.models.unet3d_ws import UNet3DWS as JaxUNet3DWS
from multimodal_tta_tpu.models.unetr import UNETR as JaxUNETR
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core import distill as tdistill
from multimodal_tta_tpu_torch.core import flax_msgpack
from multimodal_tta_tpu_torch.core import optim as toptim
from multimodal_tta_tpu_torch.core.checkpoint import load_checkpoint, load_params_only, save_checkpoint
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
from multimodal_tta_tpu_torch.models import UNETR, UNet3D, UNet3DWS
from multimodal_tta_tpu_torch.models.convert import flax_leaf_of, from_flax, to_flax, variables_from_flax
from multimodal_tta_tpu_torch.utils.logger import get_logger
from tests._torch_port import (DEVICE_TRANSFORM, SMALL, SMALL_SHAPE, assert_steps_match, bn_unet_variables,
                               flat_flax, random_flax_params, trainer_config, trainer_pair)
from tests.test_torch_seg_trainer import make_volumes

torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# the codec


def _arr(rng, shape, dtype):
    return (rng.randn(*shape) * 3).astype(dtype)


def _codec_tree(name: str):
    """``(tree for flax, tree for the port)``: the same values, the port's
    NamedTuple-style maps as ``Fields``."""
    rng = np.random.RandomState(0)
    if name == "dtypes":
        tree = {"f32": _arr(rng, (3, 4), np.float32), "bf16": np.asarray(jnp.asarray(rng.randn(5), jnp.bfloat16)),
                "i32": np.arange(-3, 300, dtype=np.int32), "step": np.asarray(7, np.int32),
                "lr": np.asarray(1e-3, np.float32), "f64": _arr(rng, (2,), np.float64), "f16": _arr(rng, (3,), np.float16),
                "i64": np.arange(4, dtype=np.int64), "u8": np.arange(17, dtype=np.uint8), "b": np.ones((2, 2), bool),
                "empty": {}, "zero_size": np.zeros((0, 3), np.float32), "npscalar": np.float32(2.5),
                "nested": {"z": {}, "a": {"kernel": _arr(rng, (3, 3, 3, 2, 4), np.float32)}}}
        return tree, tree
    if name == "scalars":  # every size class of the format's ints, strs, maps and arrays
        ints = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, -1, -32, -33, -128, -129, -32768, -32769,
                -2**31, -2**31 - 1]
        tree = {"ints": {str(i): v for i, v in enumerate(ints)}, "floats": {"a": 1.5, "b": -0.0, "c": 1e300},
                "strs": {"s31": "x" * 31, "s32": "y" * 32, "s300": "z" * 300}, "bools": {"t": True, "f": False},
                "none": None, "wide": {f"k{i:02d}": i for i in range(20)},
                "ext8": np.ones(40, np.float32), "ext16": np.ones(300, np.float32), "ext32": np.ones(17000, np.float32),
                "fixext16": np.ones(2, np.float32)}
        return tree, tree
    if name == "fields":  # an optax state: NamedTuple fields in order, a params tree sorted
        p = {"b": {"kernel": _arr(rng, (4, 3), np.float32)}, "a": {"bias": _arr(rng, (3,), np.float32)}}
        sd = serialization.to_state_dict(optax.MultiSteps(optax.adam(1e-3), 2).init(p))
        sd = jax.tree_util.tree_map(np.asarray, sd)

        def fields(d):
            if not isinstance(d, dict):
                return d
            if set(d) <= {"a", "b"}:  # a params tree: sorted, as device_get leaves it
                return {k: fields(v) for k, v in sorted(d.items())}
            return flax_msgpack.Fields((k, fields(v)) for k, v in d.items())

        return sd, fields(sd)
    raise KeyError(name)


def _equal(got, want) -> bool:
    if isinstance(want, dict):
        return isinstance(got, dict) and list(got) == list(want) and all(_equal(got[k], want[k]) for k in want)
    if isinstance(want, np.ndarray):
        if not isinstance(got, torch.Tensor) or tuple(got.shape) != want.shape:
            return False
        name = flax_msgpack._NAMES[got.dtype]
        bits = got.view(torch.uint16) if name == "bfloat16" else got
        return name == want.dtype.name and bits.numpy().tobytes() == want.tobytes()
    return type(got) is type(want) and got == want


@pytest.mark.parametrize("name", ["dtypes", "scalars", "fields"])
def test_codec_writes_and_reads_flax_bytes(name):
    flax_tree, port_tree = _codec_tree(name)
    # in place, flax keeps a NamedTuple's map in field order, as to_bytes does
    want = serialization.msgpack_serialize(flax_tree, in_place=name == "fields")
    buf = io.BytesIO()
    assert flax_msgpack.packb(port_tree, buf) == len(want)
    assert buf.getvalue() == want
    assert _equal(flax_msgpack.unpackb(bytearray(want)), serialization.msgpack_restore(want))


def test_codec_chunks_as_flax_does(monkeypatch):
    """An array over ``MAX_CHUNK_SIZE`` bytes goes in flat pieces, written
    and read, with both packages' chunk size lowered to 64 bytes."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(1)
    tree = {"w": _arr(rng, (5, 7), np.float32), "small": _arr(rng, (4,), np.float32),
            "i": np.arange(33, dtype=np.int16)}
    want = serialization.msgpack_serialize(tree)
    buf = io.BytesIO()
    flax_msgpack.packb({k: torch.from_numpy(v) for k, v in tree.items()}, buf)
    assert buf.getvalue() == want and b"__msgpack_chunked_array__" in want
    got = flax_msgpack.unpackb(bytearray(want))
    assert all(torch.equal(got[k], torch.from_numpy(v)) for k, v in tree.items())
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpackb(bytearray(want[:-3]))


# ---------------------------------------------------------------------------
# checkpoints of trained states, both ways

ADAM_WD = {"optimizer": "adam", "optimizers": {"adam": {"lr": 1e-3, "weight_decay": 5e-4}}}
CASES = {
    "adam_wd": ADAM_WD,
    "sgd_momentum_wd": {"optimizer": "sgd", "optimizers": {"sgd": {"lr": 0.01, "momentum": 0.9, "weight_decay": 1e-3}}},
    "adamw": {"optimizer": "adamw", "optimizers": {"adamw": {"lr": 1e-3, "weight_decay": 5e-4}}},
    # factored: a [3, 3, 3, 8, 16] kernel's two largest axes reach 8
    "adafactor": {"optimizer": "adafactor", "optimizers": {"adafactor": {
        "lr": 1e-2, "weight_decay": 5e-4, "min_dim_size_to_factor": 8, "momentum": 0.9}}},
    "adam_accum2": dict(ADAM_WD, grad_accum=2),
    "adam_ema": dict(ADAM_WD, ema={"enabled": True, "decay": 0.9}),
}


def _port_trainer(cfg: dict, model) -> SegTrainer:
    pcfg = ConfigNode(cfg)
    optimizer, lr = toptim.build_optimizer(pcfg.training, model)
    trainer = SegTrainer(pcfg, device_transform=DEVICE_TRANSFORM, device="cpu")
    trainer.setup(TrainState(model=model, optimizer=optimizer), None, toptim.EpochScheduler(pcfg.training, lr))
    return trainer


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Per case (made once): both packages train from the same params (the
    accumulating case 3 steps, so that its accumulator is not zero), each
    saves with its own ``save_checkpoint``, and a fresh port trainer
    restores the JAX file and writes it again."""
    runs = {}

    def get(case: str) -> dict:
        if case in runs:
            return runs[case]
        tmp = tmp_path_factory.mktemp(case)
        cfg = trainer_config(CASES[case])
        jm = JaxUNet3D(**SMALL)
        params = random_flax_params(jm, (1,) + SMALL_SHAPE, seed=3)
        jt, pt = trainer_pair(cfg, jm, UNet3D(**SMALL, device="cpu"), params)
        img, lbl = make_volumes(8, seed=7)
        batches = [{"image": img[i:i + 2], "label": lbl[i:i + 2]} for i in range(0, 8, 2)]
        n = 3 if "accum" in case else 2
        assert_steps_match(jt, pt, batches[:n], case)
        jax_save_checkpoint(str(tmp / "jax"), jt.state, {"epoch": 1})
        save_checkpoint(str(tmp / "port"), pt.state, {"epoch": 1})
        fresh = _port_trainer(cfg, UNet3D(**SMALL, device="cpu", seed=5))
        fresh.state, meta = load_checkpoint(str(tmp / "jax"), fresh.state)
        save_checkpoint(str(tmp / "again"), fresh.state)
        runs[case] = dict(cfg=cfg, jt=jt, pt=pt, fresh=fresh, meta=meta, batch=batches[n], tmp=tmp)
        return runs[case]

    return get


def _jax_moments(case: str, opt_state) -> dict:
    """The JAX optax state's per-param trees and counts by the reference's
    paths (``build_optimizer``'s chain, as probed), as nested numpy."""
    sd = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(opt_state))
    out = {"lr": None}
    if case == "adam_accum2":
        out.update(mini_step=sd["mini_step"], gradient_step=sd["gradient_step"], acc=sd["acc_grads"])
        sd = sd["inner_opt_state"]
    out["lr"] = sd["hyperparams"]["learning_rate"]
    inner = sd["inner_state"]
    if case == "sgd_momentum_wd":
        out["momentum_buffer"] = inner["1"]["0"]["trace"]
    elif case == "adafactor":
        out.update(inner["1"]["0"], ema=inner["1"]["3"]["ema"])
    else:
        adam = inner["0"]["0"] if case == "adamw" else inner["1"]["0"]
        out.update(count=adam["count"], exp_avg=adam["mu"], exp_avg_sq=adam["nu"])
    return out


def _assert_port_holds(trainer: SegTrainer, jax_state, case: str, lr=None) -> None:
    """The port trainer's state equals ``from_flax`` of the JAX state's
    trees bitwise: params, moments, counts, EMA shadow, and the learning
    rate: the file's float32 value, or ``lr`` (a port run's exact one,
    which rounds to it)."""
    st = trainer.state
    want = from_flax(jax.tree_util.tree_map(np.asarray, jax_state.params))
    sd = st.model.state_dict()
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in want)
    assert st.step == int(jax_state.step)
    mom = _jax_moments(case, jax_state.opt_state)
    want_lr = float(mom["lr"]) if lr is None else lr
    assert np.float32(want_lr) == mom["lr"] and all(g["lr"] == want_lr for g in st.optimizer.param_groups)
    rule = toptim.update_rule(st.optimizer)
    params = dict(st.model.named_parameters())
    for key in ("exp_avg", "exp_avg_sq", "momentum_buffer"):
        if key in mom:
            tree = from_flax(mom[key])
            assert all(torch.equal(rule.state[p][key], tree[n]) for n, p in params.items()), key
    if "count" in mom and case != "adafactor":
        assert all(float(rule.state[p]["step"]) == int(mom["count"]) for p in params.values())
    if case == "adafactor":
        ema, flat = from_flax(mom["ema"]), {k: flat_flax(mom[k]) for k in ("v_row", "v_col", "v")}
        leaf = flax_leaf_of(st.model)
        n_factored = 0
        for n, p in params.items():
            s = rule.state[p]
            assert s["step"] == int(mom["count"]) and torch.equal(s["mu"], ema[n])
            path = "/".join(n.split(".")[:-1] + ["kernel" if n.endswith("weight") else n.split(".")[-1]])
            for k in ("v_row", "v_col", "v"):
                if k in s:
                    want = torch.from_numpy(flat[k][path].copy())
                    if n.endswith(".up.weight"):  # optax's kernel is flipped in space, the port's view is not
                        assert want.dim() >= 3
                        want = want.flip((0, 1, 2))
                    assert torch.equal(s[k], want), (n, k)
            n_factored += "v_row" in s
            assert ("v" in s) == (leaf(n, p.detach()).dim() == flat["v"][path].ndim)
        assert n_factored > 0
    if case == "adam_accum2":
        acc = from_flax(mom["acc"])
        ms = st.optimizer
        assert (ms.mini_step, ms.gradient_step) == (int(mom["mini_step"]), int(mom["gradient_step"])) == (1, 1)
        names = {id(p): n for n, p in params.items()}
        order = [names[id(p)] for g in ms.param_groups for p in g["params"]]  # the optimizer's
        assert all(torch.equal(a, acc[n]) for a, n in zip(ms.acc, order)) and any(bool(a.any()) for a in ms.acc)
    if jax_state.ema_params is None:
        assert st.ema_params is None
    else:
        shadow = from_flax(jax.tree_util.tree_map(np.asarray, jax_state.ema_params))
        assert st.ema_params.keys() == shadow.keys()
        assert all(torch.equal(st.ema_params[k], shadow[k]) for k in shadow)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_checkpoint_restores_in_the_port(trained, case):
    """The JAX package's file restores in a fresh port trainer bitwise, and
    the next step agrees with the JAX trainer's within the parity tests'
    tolerances."""
    r = trained(case)
    assert r["meta"] == {"epoch": 1, "_format": "msgpack"}
    _assert_port_holds(r["fresh"], r["jt"].state, case)
    assert_steps_match(r["jt"], r["fresh"], [r["batch"]], f"{case} after the restore")


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_checkpoint_restores_in_jax(trained, case):
    """The port's file restores through the JAX package's
    ``load_checkpoint`` into its own template, every leaf bitwise equal to
    the port's tensors in flax's layout."""
    r = trained(case)
    pt, jt = r["pt"], r["jt"]
    template = jt.state.replace(ema_params=None)  # the reference takes the file's shadow either way
    got, meta = jax_load_checkpoint(str(r["tmp"] / "port"), template)
    assert meta["_format"] == "msgpack" and meta["epoch"] == 1
    model = pt.state.model
    want = to_flax(model.state_dict(), model)
    assert flat_flax(jax.tree_util.tree_map(np.asarray, got.params)).keys() == flat_flax(want["params"]).keys()
    for path, leaf in flat_flax(want["params"]).items():
        np.testing.assert_array_equal(np.asarray(flat_flax(got.params)[path]), leaf.numpy(), err_msg=path)
    assert int(got.step) == pt.state.step and np.asarray(got.step).dtype == np.int32
    # the port's state as the JAX trainer holds it: restored there bitwise
    probe = _port_trainer(r["cfg"], UNet3D(**SMALL, device="cpu", seed=6))
    probe.state, _ = load_checkpoint(str(r["tmp"] / "port"), probe.state)
    _assert_port_holds(probe, got, case, lr=pt.state.optimizer.param_groups[0]["lr"])
    live = toptim.update_rule(pt.state.optimizer).state
    for (n, p), q in zip(pt.state.model.named_parameters(), probe.state.model.parameters()):
        assert all(torch.equal(v, toptim.update_rule(probe.state.optimizer).state[q][k])
                   for k, v in live[p].items() if torch.is_tensor(v)), n
    if case == "adam_ema":
        shadow = to_flax(pt.state.ema_params, model)["params"]
        for path, leaf in flat_flax(shadow).items():
            np.testing.assert_array_equal(np.asarray(flat_flax(got.ema_params)[path]), leaf.numpy(), err_msg=path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_then_write_is_the_identity(trained, case):
    r = trained(case)
    a, b = (open(r["tmp"] / f, "rb").read() for f in ("jax.msgpack", "again.msgpack"))
    assert len(a) > 10_000 and a == b


def _random_state(jm, port_model, variables, training: dict, seed: int):
    """A JAX train state over ``variables`` with its optimizer's moments,
    counts and EMA shadow filled from a seed (no step compiled), and the
    port trainer that restores it."""
    rng = np.random.RandomState(seed)
    tx, _ = joptim.build_optimizer(JaxConfigNode(training), variables["params"])
    st = JaxTrainState.create(apply_fn=jm.apply, params=variables["params"], tx=tx,
                              batch_stats=variables.get("batch_stats"))

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return np.asarray(3, np.int32)
        return (np.abs(rng.randn(*a.shape)) * 0.01).astype(a.dtype) if a.ndim else a

    ema = jax.tree_util.tree_map(lambda a: (np.asarray(a) + 0.5).astype(np.float32), variables["params"])
    st = st.replace(step=jnp.asarray(3, jnp.int32), opt_state=jax.tree_util.tree_map(fill, st.opt_state),
                    ema_params=ema)
    cfg = {"task": {"seed": 0}, "training": dict(training, ema={"enabled": True, "decay": 0.9})}
    return st, _port_trainer(cfg, port_model)


UNETR_MOE = dict(in_channels=2, num_classes=1, patch_size=4, hidden_size=16, mlp_dim=32, num_heads=2, num_layers=2,
                 feature_size=4, moe_experts=2, moe_every=2)


@pytest.mark.parametrize("model", ["unet_batchnorm", "unetr_moe", "unet_ws"])
def test_read_then_write_is_the_identity_for_other_models(tmp_path, model):
    """BatchNorm statistics, DenseGeneral's reshapes and MoE experts, a
    transposed conv's flip: a JAX file read and written again by the port
    is the same bytes, and holds ``from_flax`` of its trees."""
    x_shape = (1,) + SMALL_SHAPE
    if model == "unet_batchnorm":
        jm, port = JaxUNet3D(**SMALL, norm="BATCH"), UNet3D(**SMALL, norm="BATCH", device="cpu")
        variables = bn_unet_variables(seed=4)
    elif model == "unetr_moe":
        jm, port = JaxUNETR(**UNETR_MOE), UNETR(**UNETR_MOE, image_size=SMALL_SHAPE[:3], device="cpu")
        variables = {"params": random_flax_params(jm, x_shape, seed=4)}
    else:
        jm, port = JaxUNet3DWS(**SMALL), UNet3DWS(**SMALL, device="cpu")
        variables = {"params": random_flax_params(jm, x_shape, seed=4)}
    jst, trainer = _random_state(jm, port, variables, ADAM_WD, seed=9)
    path = str(tmp_path / "m")
    jax_save_checkpoint(path, jst)
    trainer.state, _ = load_checkpoint(path, trainer.state)
    sd = trainer.state.model.state_dict()
    want = variables_from_flax(jax.tree_util.tree_map(np.asarray, {"params": jst.params,
                                                                   "batch_stats": jst.batch_stats}))
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in want)
    if model == "unet_batchnorm":
        assert any(k.endswith(".var") for k in sd)
    save_checkpoint(str(tmp_path / "again"), trainer.state)
    assert open(path + ".msgpack", "rb").read() == open(str(tmp_path / "again.msgpack"), "rb").read()


# ---------------------------------------------------------------------------
# params alone, the teacher, and two formats at one path

TEACHER_NODE = {"name": "unet", **{k: list(v) if isinstance(v, tuple) else v for k, v in SMALL.items()}}


def test_params_only_and_the_teacher_from_msgpack(tmp_path):
    jm = JaxUNet3D(**SMALL)
    params = random_flax_params(jm, (1,) + SMALL_SHAPE, seed=11)
    shadow = jax.tree_util.tree_map(lambda a: a * 0.5, params)
    base = JaxTrainState.create(apply_fn=jm.apply, params=jax.tree_util.tree_map(jnp.asarray, params),
                                tx=optax.adam(1e-3))
    jax_save_checkpoint(str(tmp_path / "plain"), base)
    jax_save_checkpoint(str(tmp_path / "ema"), base.replace(ema_params=shadow))
    assert sorted(os.listdir(tmp_path)) == ["ema.json", "ema.msgpack", "plain.json", "plain.msgpack"]
    model = UNet3D(**SMALL, device="cpu", seed=1)
    assert load_params_only(str(tmp_path / "plain"), model) is model
    assert all(torch.equal(p, from_flax(params)[n]) for n, p in model.named_parameters())
    load_params_only(str(tmp_path / "ema"), model, use_ema=True)
    assert all(torch.equal(p, from_flax(shadow)[n]) for n, p in model.named_parameters())
    with pytest.raises(ValueError, match="carries no ema_params"):
        load_params_only(str(tmp_path / "plain"), model, use_ema=True)
    for use_ema, tree in ((False, params), (True, shadow)):
        cfg = ConfigNode({"training": {"compute_dtype": "float32", "distill": {
            "enabled": True, "checkpoint": str(tmp_path / "ema"), "use_ema_params": use_ema, "model": TEACHER_NODE}}})
        teacher = tdistill.build_teacher(cfg, "cpu", SMALL_SHAPE[:3])
        assert not teacher.training and all(torch.equal(p, from_flax(tree)[n]) and not p.requires_grad
                                            for n, p in teacher.named_parameters())


def test_sidecar_decides_between_msgpack_and_pt(tmp_path):
    """With ``path.msgpack`` and ``path.pt`` both there, the sidecar's
    ``_format`` decides, else the newer file, with the reference's
    warning; so it does with ``path.orbax`` beside them."""
    cfg = {"task": {"seed": 0}, "training": ADAM_WD}
    a = _port_trainer(cfg, UNet3D(**SMALL, device="cpu", seed=1)).state
    b = _port_trainer(cfg, UNet3D(**SMALL, device="cpu", seed=2)).state
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, a, fmt="torch")
    save_checkpoint(path, b, {"epoch": 2})  # msgpack, the sidecar says so
    logger = get_logger()

    def restored(want) -> tuple:
        got = _port_trainer(cfg, UNet3D(**SMALL, device="cpu", seed=3)).state
        with mock.patch.object(logger, "warning") as warn:
            got, _ = load_checkpoint(path, got)
        ok = all(torch.equal(p, q) for p, q in zip(got.model.parameters(), want.model.parameters()))
        return ok, warn.call_args[0][0]

    ok, msg = restored(b)
    assert ok and msg == (f"[checkpoint] both {path}.msgpack and {path}.pt exist; restoring the msgpack payload "
                          "(sidecar-declared)")
    save_checkpoint(path, a, fmt="torch")  # the sidecar now says torch
    ok, msg = restored(a)
    assert ok and msg.endswith("restoring the torch payload (sidecar-declared)")
    with open(path + ".json", "w", encoding="utf-8") as f:
        f.write('{"epoch": 2}')  # a sidecar without _format: the newer file
    os.utime(path + ".pt", (1e9, 1e9))
    ok, msg = restored(b)
    assert ok and msg.endswith("restoring the msgpack payload (newer mtime)")
    save_checkpoint(path, a, fmt="orbax")  # a third format, and the sidecar says orbax
    ok, msg = restored(a)
    assert ok and msg == (f"[checkpoint] both {path}.msgpack and {path}.pt and {path}.orbax exist; restoring the "
                          "orbax payload (sidecar-declared)")
