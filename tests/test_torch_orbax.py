"""The reference's sharded orbax checkpoint format in the port
(``multimodal_tta_tpu_torch/core/ocdbt.py``, ``core/orbax_format.py``,
``core/checkpoint.py``'s ``fmt="orbax"``) against tensorstore, orbax and
the JAX package on the CPU, every leaf held bitwise (a checkpoint copies;
nothing is computed):

  - the committed reference file (``tests/data/orbax_reference``, written
    by ``scripts/make_orbax_fixture.py`` with the JAX package's
    ``save_checkpoint_sharded`` on 8 host devices: the flagship UNet3D after
    two Adam steps with EMA, and a leaf of 8 chunks) reads to its
    ``expected.npz`` in the port and in the JAX package, through Huffman
    literals and FSE-coded sequences;
  - OCDBT: the port's database lists and reads the same keys and values
    through tensorstore's OCDBT kvstore and the reverse, a tree of
    several levels included, and a corrupted CRC-32C raises;
  - per optimizer (SGD with momentum, Adam, AdamW, Adafactor, Adam with
    ``grad_accum`` 2), with and without EMA: the JAX package's ``.orbax``
    resumes in the port to the state its ``.msgpack`` gives, and the port's
    ``.orbax`` restores in the JAX package's ``load_checkpoint`` to the
    leaves of the port's ``.msgpack``;
  - a chunk missing from a leaf's grid raises; a save cut between
    ``commit``'s two renames leaves the earlier checkpoint readable;
  - ``training.checkpoint_format`` orbax and sharded through
    ``ExperimentManager``: the files, the resume, ``.orbax`` beside
    ``.msgpack``, ``load_params_only``'s ``ValueError``, the EMA toggle's,
    and ``cli.adapt``, ``cli.predict`` and ``cli.export_serving`` from the
    ``.orbax`` ``cli.train`` wrote;
  - two gloo ranks over a model axis each write only their own chunks, and
    one process and the JAX package read the gathered tree."""

import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core import optim as joptim
from multimodal_tta_tpu.core.checkpoint import load_checkpoint as jax_load_checkpoint
from multimodal_tta_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from multimodal_tta_tpu.core.checkpoint import save_checkpoint_sharded as jax_save_checkpoint_sharded
from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core import ocdbt, orbax_format, zstd
from multimodal_tta_tpu_torch.core import optim as toptim
from multimodal_tta_tpu_torch.core.checkpoint import load_checkpoint, load_params_only, save_checkpoint
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.core.trainers.seg_trainer import SegTrainer
from multimodal_tta_tpu_torch.models import UNet3D
from multimodal_tta_tpu_torch.utils.logger import get_logger

from _torch_port import DEVICE_TRANSFORM, SMALL, SMALL_SHAPE, random_flax_params

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "orbax_reference")


def _leaves(payload) -> dict:
    """``{orbax param name: numpy array}`` of a payload (bfloat16 as its
    bits); an empty node as its value type."""
    out = {}
    for keys, v in orbax_format.flatten(payload):
        name = ".".join(k for k, _ in keys)
        if isinstance(v, str):
            out[name] = v
            continue
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        out[name] = (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()
    return out


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _jax_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in path)
        a = np.asarray(leaf)
        out[name] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return out


# ---------------------------------------------------------------------------
# the reference's own file


def test_reference_fixture_reads_bitwise_in_the_port_and_in_jax():
    want = np.load(os.path.join(FIXTURE, "expected.npz"))
    zstd.reset_counters()
    stats = {}
    got = _leaves(orbax_format.load(os.path.join(FIXTURE, "ckpt.orbax"), stats=stats))
    modes = zstd.counters()
    arrays = {k: v for k, v in got.items() if not isinstance(v, str)}
    assert sorted(arrays) == sorted(want.files) and len(want.files) > 150
    assert all(_same(arrays[k], want[k]) for k in want.files)
    assert got["opt_state.hyperparams_states"] == "Dict" and stats["chunks"] > len(want.files)
    # the leaf sharded over `data` is 8 chunks; tensorstore's frames took
    # Huffman literals (FSE-coded weights) and FSE-coded sequences
    with ocdbt.Database(os.path.join(FIXTURE, "ckpt.orbax")) as db:
        keys = [e.key for e in db.entries()]
    assert sum(k.startswith(b"batch_stats.acc/") and not k.endswith(b".zarray") for k in keys) == 8
    assert modes["literals_huffman_4streams"] > 0 and modes["weights_fse"] > 0 and modes["sequences_fse"] > 0
    # the JAX package restores the same leaves (a real reference file)
    params = jax.tree_util.tree_map(jnp.zeros_like, random_flax_params(JaxUNet3D(**SMALL), (1,) + SMALL_SHAPE))
    tx, _ = joptim.build_optimizer(JaxConfigNode({"optimizer": "adam", "optimizers": {
        "adam": {"lr": 1e-3, "weight_decay": 5e-4}}}), params)
    template = JaxTrainState.create(apply_fn=None, params=params, tx=tx,
                                    batch_stats={"acc": jnp.zeros((8, 2048), jnp.float32)}).replace(ema_params=params)
    restored, meta = jax_load_checkpoint(os.path.join(FIXTURE, "ckpt"), template)
    assert meta == {"epoch": 1, "best_metrics": {"dice": 0.5}, "_format": "orbax"}
    jleaves = _jax_leaves({"step": restored.step, "params": restored.params, "batch_stats": restored.batch_stats,
                           "opt_state": restored.opt_state, "ema_params": restored.ema_params})
    assert sorted(jleaves) == sorted(want.files) and all(_same(jleaves[k], want[k]) for k in want.files)


# ---------------------------------------------------------------------------
# OCDBT against tensorstore


def _ts_items(root: str) -> dict:
    kv = ts.KvStore.open(f"file://{root}/|ocdbt:").result()
    return {k: kv[k] for k in kv.list().result()}


def test_ocdbt_against_tensorstore_both_ways(tmp_path):
    rng = np.random.RandomState(0)
    items = {f"params.layer{i:03d}/{j}.0".encode(): rng.bytes(int(rng.randint(0, 2500)))
             for i in range(60) for j in range(2)}
    # the port writes (a small node limit: a tree of several levels), tensorstore reads
    config = ocdbt.Config(os.urandom(16), max_decoded_node_bytes=1500)
    ocdbt.write_database(str(tmp_path / "port"), items.items(), config=config)
    assert _ts_items(str(tmp_path / "port")) == items
    with ocdbt.Database(str(tmp_path / "port")) as db:
        assert db.version.root_height >= 2 and db.items() == items
    # tensorstore writes (several commits, values inline and in data files), the port reads
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path / 'ts'}/",
                          "config": {"max_decoded_node_bytes": 800, "version_tree_arity_log2": 1}}).result()
    with ts.Transaction() as txn:
        for k, v in list(items.items())[:80]:
            kv.with_transaction(txn)[k] = v
    for k, v in list(items.items())[80:]:
        kv[k] = v
    with ocdbt.Database(str(tmp_path / "ts")) as db:
        assert db.items() == items == _ts_items(str(tmp_path / "ts"))
        assert db.manifest.version_nodes and [v.generation for v in db.all_versions()] == list(
            range(1, db.version.generation + 1))
    # a corrupted CRC-32C raises
    raw = bytearray(open(tmp_path / "port" / "manifest.ocdbt", "rb").read())
    raw[20] ^= 1
    open(tmp_path / "port" / "manifest.ocdbt", "wb").write(bytes(raw))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C mismatch"):
        ocdbt.Database(str(tmp_path / "port"))


# ---------------------------------------------------------------------------
# every optimizer, both ways

OPTIMIZERS = {
    "sgd": {"optimizer": "sgd", "optimizers": {"sgd": {"lr": 0.01, "momentum": 0.9, "weight_decay": 1e-3}}},
    "adam": {"optimizer": "adam", "optimizers": {"adam": {"lr": 1e-3, "weight_decay": 5e-4}}},
    "adamw": {"optimizer": "adamw", "optimizers": {"adamw": {"lr": 1e-3, "weight_decay": 5e-4}}},
    "adafactor": {"optimizer": "adafactor", "optimizers": {"adafactor": {
        "lr": 1e-2, "weight_decay": 5e-4, "min_dim_size_to_factor": 8, "momentum": 0.9}}},
    "grad_accum": {"optimizer": "adam", "optimizers": {"adam": {"lr": 1e-3}}, "grad_accum": 2},
}


@pytest.fixture(scope="module")
def flax_params():
    return random_flax_params(JaxUNet3D(**SMALL), (1,) + SMALL_SHAPE, seed=4)


def _jax_state(training: dict, params, ema: bool, seed: int):
    """A JAX train state with its optimizer's moments and counts filled
    from a seed (nothing compiled), EMA shadow when ``ema``."""
    rng = np.random.RandomState(seed)
    tx, _ = joptim.build_optimizer(JaxConfigNode(training), params)
    st = JaxTrainState.create(apply_fn=None, params=jax.tree_util.tree_map(jnp.asarray, params), tx=tx)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return np.asarray(1, np.int32)
        return (np.abs(rng.randn(*a.shape)) * 0.01).astype(a.dtype) if a.ndim else a

    shadow = jax.tree_util.tree_map(lambda a: (np.asarray(a) * 0.5 + 0.25).astype(np.float32), params)
    return st.replace(step=jnp.asarray(3, jnp.int32), opt_state=jax.tree_util.tree_map(fill, st.opt_state),
                      ema_params=shadow if ema else None)


def _port_state(training: dict, ema: bool, seed: int) -> TrainState:
    cfg = ConfigNode({"task": {"seed": 0}, "training": dict(training, ema={"enabled": ema, "decay": 0.9})})
    model = UNet3D(**SMALL, device="cpu", seed=seed)
    optimizer, lr = toptim.build_optimizer(cfg.training, model)
    trainer = SegTrainer(cfg, device_transform=DEVICE_TRANSFORM, device="cpu")
    trainer.setup(TrainState(model=model, optimizer=optimizer), None, toptim.EpochScheduler(cfg.training, lr))
    if ema:  # the shadow a trainer makes at its first step
        trainer.state.ema_params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return trainer.state


def _tensors(x, prefix=""):
    """Every tensor and number of a state dict, by path."""
    if isinstance(x, dict):
        return {k2: v2 for k, v in x.items() for k2, v2 in _tensors(v, f"{prefix}/{k}").items()}
    if isinstance(x, (list, tuple)):
        return {k2: v2 for i, v in enumerate(x) for k2, v2 in _tensors(v, f"{prefix}/{i}").items()}
    return {prefix: x}


def _assert_states_equal(a: TrainState, b: TrainState) -> None:
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = _tensors(a.optimizer.state_dict()), _tensors(b.optimizer.state_dict())
    assert oa.keys() == ob.keys()
    for k in oa:
        same = torch.equal(oa[k], ob[k]) if torch.is_tensor(oa[k]) else oa[k] == ob[k]
        assert same, k
    assert (a.ema_params is None) == (b.ema_params is None)
    if a.ema_params is not None:
        assert all(torch.equal(a.ema_params[k], b.ema_params[k]) for k in a.ema_params)


@pytest.mark.parametrize("ema", [False, True], ids=["plain", "ema"])
@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_orbax_both_ways(tmp_path, flax_params, case, ema):
    training = OPTIMIZERS[case]
    jst = _jax_state(training, flax_params, ema, seed=len(case))
    jax_save_checkpoint(str(tmp_path / "jax"), jst, {"epoch": 2})
    jax_save_checkpoint_sharded(str(tmp_path / "jax_o"), jst, {"epoch": 2})
    # the JAX package's .orbax resumes in the port as its .msgpack does
    from_msgpack, meta_m = load_checkpoint(str(tmp_path / "jax"), _port_state(training, ema, seed=1))
    from_orbax, meta_o = load_checkpoint(str(tmp_path / "jax_o"), _port_state(training, ema, seed=2))
    assert meta_m == {"epoch": 2, "_format": "msgpack"} and meta_o == {"epoch": 2, "_format": "orbax"}
    _assert_states_equal(from_orbax, from_msgpack)
    # the port's .orbax restores in the JAX package as the port's .msgpack does
    save_checkpoint(str(tmp_path / "port"), from_orbax, {"epoch": 3})
    save_checkpoint(str(tmp_path / "port_o"), from_orbax, {"epoch": 3}, fmt="orbax")
    assert not os.path.exists(tmp_path / "port_o.orbax.tmp")
    got_m, _ = jax_load_checkpoint(str(tmp_path / "port"), jst)
    got_o, meta = jax_load_checkpoint(str(tmp_path / "port_o"), jst)
    assert meta["_format"] == "orbax" and meta["epoch"] == 3
    a, b = (_jax_leaves({"step": s.step, "params": s.params, "opt_state": s.opt_state, "ema": s.ema_params})
            for s in (got_m, got_o))
    assert a.keys() == b.keys() and len(a) > 40 and all(_same(a[k], b[k]) for k in a)
    # the port writes the reference's tree: its _METADATA names every leaf
    # and empty node as orbax's own does
    ref = json.load(open(tmp_path / "jax_o.orbax" / "_METADATA"))["tree_metadata"]
    mine = json.load(open(tmp_path / "port_o.orbax" / "_METADATA"))["tree_metadata"]
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k]["key_metadata"] == ref[k]["key_metadata"], k
        assert mine[k]["value_metadata"]["value_type"] == ref[k]["value_metadata"]["value_type"], k


def test_a_missing_chunk_raises(tmp_path):
    """A leaf of two chunks, one a rank, with rank 1's never written: the
    reader raises, naming the leaf and the chunk, where ``_METADATA`` says
    every chunk was stored (as orbax and the port write it), and reads the
    missing chunk as the fill value where it does not."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    leaves = [orbax_format.Leaf((("params", 2), ("w", 2)), (2, 3), torch.float32, (1, 3), {(0, 0): t[:1]})]
    directory = str(tmp_path / "ck.orbax")
    orbax_format.write_process(directory, leaves, 0)
    orbax_format.finalize(directory, leaves, processes=1)
    with pytest.raises(orbax_format.OrbaxError, match=r"chunk \(1, 0\) of params\.w is missing"):
        orbax_format.load(directory)
    meta = json.load(open(os.path.join(directory, "_METADATA")))
    del meta["store_array_data_equal_to_fill_value"]
    json.dump(meta, open(os.path.join(directory, "_METADATA"), "w"))
    assert torch.equal(orbax_format.load(directory)["params"]["w"], torch.cat([t[:1], torch.zeros(1, 3)]))


def test_a_save_cut_between_the_renames_keeps_the_earlier_checkpoint(tmp_path):
    """A save cut after ``commit`` moved the earlier ``path.orbax`` to
    ``path.orbax.old`` and before its new one stood: the earlier checkpoint
    still resumes, through ``load_checkpoint`` and ``CheckpointHook.load``,
    and the next save keeps it until its own directory is in place."""
    from multimodal_tta_tpu_torch.core.hooks import CheckpointHook

    path = str(tmp_path / "ck")
    first = _port_state(OPTIMIZERS["adam"], False, seed=1)
    save_checkpoint(path, first, {"epoch": 1}, fmt="orbax")
    os.replace(path + ".orbax", path + ".orbax.old")  # where the cut leaves it
    os.makedirs(path + ".orbax.tmp")  # and the torn new one
    got, meta = load_checkpoint(path, _port_state(OPTIMIZERS["adam"], False, seed=2))
    assert meta["epoch"] == 1
    _assert_states_equal(got, first)
    hook = CheckpointHook(str(tmp_path), fmt="orbax")
    hook.trainer = mock.MagicMock(state=_port_state(OPTIMIZERS["adam"], False, seed=3), scheduler=None,
                                  best_metrics={})
    assert hook.load(path) == 2
    _assert_states_equal(hook.trainer.state, first)
    second = _port_state(OPTIMIZERS["adam"], False, seed=4)
    save_checkpoint(path, second, {"epoch": 2}, fmt="orbax")
    assert sorted(os.listdir(tmp_path)) == ["ck.json", "ck.orbax"]
    got, meta = load_checkpoint(path, _port_state(OPTIMIZERS["adam"], False, seed=5))
    assert meta["epoch"] == 2
    _assert_states_equal(got, second)


# ---------------------------------------------------------------------------
# the manager, the hook and the CLI


def test_checkpoint_format_orbax_through_the_manager(tmp_path):
    """``training.checkpoint_format`` orbax and its alias sharded: the files,
    and a run resumed from an orbax ``best_model`` through
    ``training.resume`` equals an uninterrupted run bitwise."""
    from test_torch_checkpoint import assert_states_equal, manager_config, run_manager

    def cfg(name, **training):
        return manager_config(str(tmp_path / name), checkpoint_format=training.pop("fmt"), **training)

    full, _ = run_manager(cfg("full", fmt="orbax", epochs=2), 2)
    first, _ = run_manager(cfg("first", fmt="sharded", epochs=2), 1)
    for m in (full, first):
        names = sorted(os.listdir(m.checkpoint_hook.save_dir))
        assert m.checkpoint_hook.fmt == "orbax" and "best_model.orbax" in names and "best_model.json" in names
        assert not any(n.endswith((".msgpack", ".pt", ".tmp")) for n in names)
    path = os.path.join(first.checkpoint_hook.save_dir, "best_model")
    assert json.load(open(path + ".json"))["_format"] == "orbax"
    resumed, _ = run_manager(cfg("resumed", fmt="orbax", epochs=2, resume=path), 2)
    assert resumed.trainer.start_epoch == 1
    assert_states_equal(resumed.state, full.state)
    # .orbax beside .msgpack: the sidecar decides
    state = first.state
    other = _port_state(OPTIMIZERS["adam"], False, seed=9)
    save_checkpoint(path, other, {"epoch": 5})  # msgpack now, the sidecar says so
    with mock.patch.object(get_logger(), "warning") as warn:
        got, meta = load_checkpoint(path, _port_state(OPTIMIZERS["adam"], False, seed=3))
    assert meta["epoch"] == 5 and warn.call_args[0][0].endswith("restoring the msgpack payload (sidecar-declared)")
    assert all(torch.equal(p, q) for p, q in zip(got.model.parameters(), other.model.parameters()))
    # params alone: an orbax checkpoint without a .msgpack raises the reference's ValueError
    os.remove(path + ".msgpack")
    with pytest.raises(ValueError, match="orbax-format; params-only loading needs the msgpack format"):
        load_params_only(path, UNet3D(**SMALL, device="cpu"))
    # EMA toggled between the orbax save and the resume raises, as in the reference
    save_checkpoint(path, state, fmt="orbax")
    with pytest.raises(ValueError, match="matching tree only"):
        load_checkpoint(path, _port_state(OPTIMIZERS["adam"], True, seed=3))


def test_cli_adapt_predict_and_export_from_an_orbax_checkpoint(tmp_path):
    """``cli.train`` with ``training.checkpoint_format=orbax`` writes
    ``best_model.orbax``; ``cli.adapt``, ``cli.predict`` and
    ``cli.export_serving`` take it through ``training.resume``, the
    artifact's params bitwise the file's."""
    from multimodal_tta_tpu_torch.cli import adapt, export_serving, predict, train
    from multimodal_tta_tpu_torch.data.synthetic import make_hecktor_fixture
    from multimodal_tta_tpu_torch.models.convert import variables_from_flax
    from multimodal_tta_tpu_torch.serving.export import load_artifact

    man = make_hecktor_fixture(str(tmp_path / "hek"), shape=(16, 16, 16))
    common = [f"dataset.manifest_csv={man}", "dataset.expected_shape=[16,16,16]",
              "training.data.transforms.image_size=[16,16,16]", "model.channels=[2,4,8]", "model.strides=[2,2]",
              "training.compute_dtype=float32", "training.batch_size=2", "training.epochs=1",
              "training.model_save_start=0", "dataset.val_per_center=1", f"task.save_dir={tmp_path / 'out'}"]
    artifact = str(tmp_path / "tent.mttap")
    cwd = os.getcwd()
    try:
        train.main(common + ["training.checkpoint_format=orbax"], device="cpu")
        found = [os.path.join(d, n) for d, ds, _ in os.walk(tmp_path / "out") for n in ds if n == "best_model.orbax"]
        assert len(found) == 1
        ckpt = found[0][:-len(".orbax")]
        resume = f"training.resume={ckpt}"
        metrics = adapt.main(common + ["tta=tent", "tta.report_no_adapt=true", resume], device="cpu")
        rows = predict.main(common + ["tta=tent", "tta.episodic=false", resume], device="cpu")
        export_serving.main(common + ["tta=tent", resume, "+export.batch_size=2", f"+export.path={artifact}"],
                            device="cpu")
    finally:
        os.chdir(cwd)
    assert set(metrics) == {"no_adapt", "adapted"} and rows and all(r["status"] == "ok" for r in rows)
    raw = orbax_format.load(ckpt + ".orbax")
    want = variables_from_flax({"params": raw["params"], "batch_stats": raw["batch_stats"]})
    art = load_artifact(artifact, "cpu")
    names = [a["name"] for a in art.meta["args"][:art.n_state]]
    got = {n.split(":", 1)[1]: t for n, t in zip(names, art.initial_state()) if n.startswith("param:")}
    assert got and all(torch.equal(t, want[k]) for k, t in got.items())


# ---------------------------------------------------------------------------
# ranks: each writes its own chunks


def test_model_axis_ranks_write_their_own_chunks(tmp_path):
    """``data=1 x model=2`` (two gloo ranks, ``tests/_torch_tp_worker.py``):
    UNETR with SGD momentum and EMA takes two steps and saves as msgpack
    (gathered to rank 0) and as orbax. In the orbax file rank 1's database
    holds only its cuts of the sharded params, EMA shadows and momentum
    buffers, one chunk each, and rank 0's the rest; one process and the
    JAX package read the gathered msgpack tree from it bitwise. With
    Adafactor (its factored statistics no block of a cut) the whole tree is
    gathered and rank 0 writes it, as for msgpack."""
    from multimodal_tta_tpu.models.unetr import UNETR as JaxUNETR
    from multimodal_tta_tpu_torch.core import flax_msgpack
    from _torch_tp_worker import spawn
    from test_torch_tensor_parallel import SGD, TRAIN, UNETR_PARAMS, trainer_config

    training = dict(SGD, ema={"enabled": True, "decay": 0.9})
    adafactor = {"optimizer": "adafactor", "optimizers": {"adafactor": {"lr": 1e-2, "min_dim_size_to_factor": 8}}}
    ckpt, gathered = str(tmp_path / "tp"), str(tmp_path / "tp_adafactor")
    spawn([("train", dict(TRAIN, cfg=trainer_config(training), checkpoint=ckpt, formats=("msgpack", "orbax"))),
           ("train", dict(TRAIN, cfg=trainer_config(adafactor), batches=TRAIN["batches"][:1], checkpoint=gathered,
                          formats=("msgpack", "orbax")))],
          str(tmp_path), world=2, timeout=240)
    want = _leaves(flax_msgpack.load(gathered + ".msgpack"))
    got = _leaves(orbax_format.load(gathered + ".orbax"))
    assert got.keys() == want.keys() and any(".v_row." in k for k in want) and all(
        _same(got[k], v) if not isinstance(v, str) else got[k] == v for k, v in want.items())
    with ocdbt.Database(gathered + ".orbax/ocdbt.process_1") as db:
        assert not list(db.entries())  # rank 1 wrote nothing
    whole = _leaves(flax_msgpack.load(ckpt + ".msgpack"))
    got = _leaves(orbax_format.load(ckpt + ".orbax"))
    assert got.keys() == whole.keys() and all(
        _same(got[k], v) if not isinstance(v, str) else got[k] == v for k, v in whole.items())
    with ocdbt.Database(ckpt + ".orbax/ocdbt.process_1") as db:
        own = {e.key.decode(): len(db.read(e)) for e in db.entries()}
    with ocdbt.Database(ckpt + ".orbax/ocdbt.process_0") as db:
        lead = {e.key.decode(): len(db.read(e)) for e in db.entries()}
    cut = {k.rpartition("/")[0] for k in own}
    assert cut and all(any(w in n for w in ("query", "key", "value", "out", "Dense_0", "Dense_1")) for n in cut)
    assert {n.split(".")[0] for n in cut} == {"params", "ema_params", "opt_state"}
    for name in cut:  # two chunks, one each; the cut axis holds the rank
        index = [k.rpartition("/")[2] for k in own if k.startswith(name + "/")]
        assert len(index) == 1 and index[0] != "0" * len(index[0]) and f"{name}/.zarray" in lead
        assert sum(k.startswith(name + "/") and not k.endswith(".zarray") for k in lead) == 1
    assert not any(k.endswith(".zarray") for k in own) and sum(own.values()) < sum(lead.values())
    # the JAX package restores the same leaves (a template of the reference's UNETR state)
    jparams = jax.tree_util.tree_map(jnp.asarray, UNETR_PARAMS)
    tx, _ = joptim.build_optimizer(JaxConfigNode(training), jparams)
    template = JaxTrainState.create(apply_fn=JaxUNETR(in_channels=2, num_classes=1).apply, params=jparams,
                                    tx=tx).replace(ema_params=jparams)
    restored, meta = jax_load_checkpoint(ckpt, template)  # the sidecar names orbax
    assert meta["_format"] == "orbax"
    jleaves = _jax_leaves({"step": restored.step, "params": restored.params, "opt_state": restored.opt_state,
                           "ema_params": restored.ema_params})
    arrays = {k: v for k, v in whole.items() if not isinstance(v, str) and not k.startswith("batch_stats")}
    assert jleaves.keys() == arrays.keys() and all(_same(jleaves[k], arrays[k]) for k in arrays)
