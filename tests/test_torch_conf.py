"""The port's config stack (multimodal_tta_tpu_torch/conf/: yaml_subset.py,
node.py, compose.py) against PyYAML and the JAX package's conf/: the YAML
reader gives what ``yaml.safe_load`` gives on every file under configs/ and
on the CLI override values of tests/test_config.py and tests/test_cli_e2e.py;
``ConfigNode`` merges, interpolates and sets paths as the reference's does;
``compose`` gives equal containers on the same override sets; the phase-11
training recipe of chip_smoke.py is the JAX compose of its overrides."""

import glob
import math
import os

import pytest
import yaml

import chip_smoke
from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.conf import compose as jax_compose
from multimodal_tta_tpu.conf import from_yaml_str as jax_from_yaml_str
from multimodal_tta_tpu.conf.compose import _parse_cli_value as jax_parse_cli_value
from multimodal_tta_tpu.conf.compose import parse_overrides as jax_parse_overrides
from multimodal_tta_tpu_torch.conf import ConfigNode, compose, from_yaml_str, load_yaml_file, parse_overrides
from multimodal_tta_tpu_torch.conf import setup_run_dir, yaml_subset
from multimodal_tta_tpu_torch.conf.compose import _parse_cli_value

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "configs")
CONFIG_FILES = sorted(os.path.relpath(p, CONFIG_DIR)
                      for p in glob.glob(os.path.join(CONFIG_DIR, "**", "*.yaml"), recursive=True))

# the override values of tests/test_config.py and tests/test_cli_e2e.py:42-59
# (and the other CLI tests of that file), plus YAML 1.1's corner cases
CLI_VALUES = [
    "false", "0", "3", "2", "CHUM", "5e-3", "[1]", "true", "hecktor21", "4", "myrun", "brats", "/x/y.csv",
    "does_not_exist", "tent", "cotta_restore", "eata_gate", "cotta", "[0,1,2]",
    "/tmp/fix/manifest.csv", "[16,16,16]", "1", "float32", "[2,4,8,16,32]", "/tmp/out/outputs", "cli_train",
    "^(dec0|up0)", '["CHUS","CHUM"]', "[CHUS,CHUM]", "reset_on_domain_change", "0.5", "10.0",
    "1e-4", "1.0e-5", "1e5", "010", "0x1F", "0b101", "1:30", "1_000", ".inf", "-.inf", "+.5", "1.",
    "yes", "Off", "~", "null", "", "2020-01-01", "2001-12-14t21:59:43.10-05:00", "'a''b'",
    '"esc\\n\\x41\\u00e9"', "a #c", "a#b", "{a: 1, b: [2, 3]}", "[a: 1, b]", "{a, b: 1}", "[1, 2, ]",
    "a: b", "- 1", "foo:bar", "${task.save_dir}/${now:%Y%m%d}", "*alias", "[1,2",
]

# override sets whose composition is compared (hydra.run.dir is added so that
# neither side reads the clock)
OVERRIDE_SETS = [
    [],
    ["task=brats", "dataset=brats"],
    ["training.epochs=3", "training.batch_size=2", "dataset.target_center=CHUM",
     "training.optimizers.adam.lr=5e-3", "training.gpu_ids=[1]"],
    ["+extra.flag=true"],
    ["tta=tent", "tta.steps=4"],
    ["task.run_name=myrun"],
    ["dataset=brats", "task=brats", "dataset.sources.0.csv_path=/x/y.csv"],
    ["~method"],
    ["training.eval_on_train=true", "training.gpu_ids=[0,1,2]"],
    ["tta=cotta_restore"],
    ["tta=eata_gate"],
    ["tta=cotta"],
    ["dataset.manifest_csv=/tmp/fix/manifest.csv", "dataset.expected_shape=[16,16,16]",
     "dataset.val_per_center=1", "training.epochs=1", "training.batch_size=2", "training.eval_batch_size=2",
     "training.num_workers=0", "training.compute_dtype=float32", "training.data.transforms.image_size=[16,16,16]",
     "training.model_save_start=1", "training.model_save_freq=1", "model.channels=[2,4,8,16,32]",
     "model.num_res_units=1", "task.save_dir=/tmp/out/outputs", "task.run_name=cli_train",
     "tta=tent", "tta.steps=1", "tta.update_path_regex=^(dec0|up0)", "tta.report_no_adapt=true"],
    ["tta=tent", "tta.episodic=false", "tta.stream.enabled=true", "tta.stream.policy=reset_on_domain_change",
     "tta.stream.domain_order=[CHUS,CHUM]", 'sweep.centers=["CHUS","CHUM"]'],
]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_reader_equals_safe_load_on_every_config(name):
    with open(os.path.join(CONFIG_DIR, name), encoding="utf-8") as f:
        text = f.read()
    want = yaml.safe_load(text)
    assert yaml_subset.load(text) == want
    # what the writer makes of it reads back equal on both readers
    out = yaml_subset.dump(want)
    assert yaml_subset.load(out) == want and yaml.safe_load(out) == want


def test_all_forty_configs_are_covered():
    assert len(CONFIG_FILES) == 40


@pytest.mark.parametrize("raw", CLI_VALUES)
def test_cli_values_as_safe_load_and_the_reference_parse_them(raw):
    try:
        want, failed = yaml.safe_load(raw), False
    except yaml.YAMLError:
        failed = True
    if failed:
        with pytest.raises(yaml_subset.YAMLSubsetError):
            yaml_subset.load(raw)
    else:
        assert _same(yaml_subset.load(raw), want)
    assert _same(_parse_cli_value(raw), jax_parse_cli_value(raw))


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  text\n", "a: >\n  text\n", "? a\n: b\n",
    "--- 1\n", "%YAML 1.1\n---\na: 1\n", "a: b: c\n", "a:\n  b\n  c\n", "a: [1, 2\n", "a: 'x\n",
    "<<: {a: 1}\n", "a:\n\t- 1\n", "&anchor",
])
def test_outside_the_subset_raises(text):
    with pytest.raises(yaml_subset.YAMLSubsetError):
        yaml_subset.load(text)


def test_writer_round_trips_awkward_values():
    data = {"strings": ["yes", "1e-4", "010", "", " lead", "a: b", "#x", "x #y", "[a]", "'q'", '"q"', "~",
                        "2020-01-01", "${a.b}/${now:%Y}", "é", "tab\there", "line\nbreak", "null"],
            "numbers": [0, -3, 1e-05, 1e20, -0.0, float("inf"), 2.5], "flags": [True, False, None],
            "nested": [{"a": [1, [2, 3]], "b": {}}, [], [[1], {"k": "v"}]], "1": "int-like key",
            "empty": {}, "deep": {"x": {"y": {"z": [1.5]}}}}
    out = yaml_subset.dump(data)
    assert yaml_subset.load(out) == data
    assert yaml.safe_load(out) == data


MERGE_CASES = [
    ({"m": {"x": 1, "y": 2}}, {"m": {"y": 3, "z": 4}}),
    ({"a": [1, 2], "b": {"c": 1}}, {"a": [3], "b": 5}),
    ({"a": 1}, {"b": {"c": [{"d": 1}]}}),
]


@pytest.mark.parametrize("base,other", MERGE_CASES)
def test_merge_matches_reference(base, other):
    got = ConfigNode(base).merge(other)
    want = JaxConfigNode(base).merge(other)
    assert got.to_container() == want.to_container()
    got = ConfigNode(base).merge(ConfigNode(other))
    assert got.to_container() == want.to_container()


INTERP_TEXTS = [
    "a: hello\nb: ${a}_world\nc:\n  d: ${b}\n",
    "n: 5\nm: ${n}\nl: ['${n}', \"x${n}\"]\n",
    "task:\n  save_dir: ./out\n  run_name: r\nhydra:\n  run:\n    dir: ${task.save_dir}/${task.run_name}\n",
]


@pytest.mark.parametrize("text", INTERP_TEXTS)
def test_interpolation_matches_reference(text):
    assert from_yaml_str(text).resolve().to_container() == jax_from_yaml_str(text).resolve().to_container()


def test_interpolation_edges():
    assert len(str(from_yaml_str("d: ${now:%Y}\n").resolve().d)) == 4
    # as in the reference, a path that is not there resolves to None
    assert from_yaml_str("a: ${missing.key}\n").resolve().a is None
    assert jax_from_yaml_str("a: ${missing.key}\n").resolve().a is None
    with pytest.raises(ValueError, match="cycle"):
        from_yaml_str("a: ${b}\nb: ${a}\n").resolve()


@pytest.mark.parametrize("path,value", [
    ("x.y.z", 3), ("a.1", 9), ("a.0.k", "v"), ("b", {"c": 1}), ("new.list", [1, {"d": 2}]),
])
def test_set_path_select_and_has_path_match_reference(path, value):
    base = {"a": [{"k": 1}, 2], "b": 0}
    got, want = ConfigNode(base), JaxConfigNode(base)
    got.set_path(path, value)
    want.set_path(path, value)
    assert got.to_container() == want.to_container()
    assert ConfigNode({"v": got.select(path)}).to_container() == JaxConfigNode({"v": want.select(path)}).to_container()
    assert got.has_path(path) and not got.has_path(path + ".nope")


def test_node_mapping_surface():
    cfg = ConfigNode({"a": {"b": 1}, "c": [1, 2]})
    cfg.d = {"e": 2}
    cfg["f"] = 3
    assert cfg.d.e == 2 and cfg.f == 3
    del cfg["f"]
    assert "f" not in cfg
    assert cfg.pop("c") == [1, 2] and cfg.pop("zz", 7) == 7
    assert cfg.setdefault("g", {"h": 1}).h == 1
    copy = cfg.copy()
    copy.a.b = 5
    assert cfg.a.b == 1
    assert cfg == {"a": {"b": 1}, "d": {"e": 2}, "g": {"h": 1}}
    assert from_yaml_str(cfg.to_yaml()) == cfg


def test_load_yaml_file_reads_the_package_directive():
    node, package = load_yaml_file(os.path.join(CONFIG_DIR, "_global_patches", "hecktor21.yaml"))
    assert package == "_global_"
    assert node.model.channels == [32, 64, 128, 256, 512]
    assert load_yaml_file(os.path.join(CONFIG_DIR, "tta", "tent.yaml"))[1] is None


@pytest.mark.parametrize("overrides", OVERRIDE_SETS, ids=range(len(OVERRIDE_SETS)))
def test_compose_matches_reference(overrides):
    ov = list(overrides) + ["hydra.run.dir=/tmp/run_dir", "hydra.job.chdir=false"]
    assert compose(CONFIG_DIR, "config", ov).to_container() == jax_compose(CONFIG_DIR, "config", ov).to_container()


def test_parse_overrides_matches_reference():
    toks = ["a=1", "+b.c=[1,2]", "++d=x", "~e", "f=5e-3", "g="]
    got = [(o.key, o.value, o.kind) for o in parse_overrides(toks)]
    want = [(o.key, o.value, o.kind) for o in jax_parse_overrides(toks)]
    assert got == want
    with pytest.raises(ValueError, match="expected key=value"):
        parse_overrides(["novalue"])


def test_compose_errors():
    with pytest.raises(FileNotFoundError):
        compose(CONFIG_DIR, "config", ["task=does_not_exist"])
    cfg = compose(CONFIG_DIR, "config", ["task.run_name=myrun"])
    assert "outputs/hecktor21" in cfg.hydra.run.dir and "myrun" in cfg.hydra.run.dir


def test_setup_run_dir_saves_the_config_and_changes_directory(tmp_path):
    run_dir = tmp_path / "run"
    cfg = compose(CONFIG_DIR, "config", ["tta=tent", f"hydra.run.dir={run_dir}"])
    cwd = os.getcwd()
    try:
        got = setup_run_dir(cfg)
        assert got == str(run_dir) and os.getcwd() == str(run_dir)
    finally:
        os.chdir(cwd)
    with open(run_dir / ".hydra_equiv" / "config.yaml", encoding="utf-8") as f:
        text = f.read()
    assert yaml.safe_load(text) == cfg.to_container() == yaml_subset.load(text)
    no_chdir = compose(CONFIG_DIR, "config", [f"hydra.run.dir={tmp_path / 'other'}", "hydra.job.chdir=false"])
    setup_run_dir(no_chdir)
    assert os.getcwd() == cwd


def test_chip_smoke_phase11_recipe_is_the_composed_config(tmp_path):
    """chip_smoke.py's training recipe comes from the port's compose of its
    overrides, equal to the JAX compose of the same overrides, and holds the
    recipe phase 11 checks against."""
    save_dir = str(tmp_path / "train")
    got = chip_smoke.train_recipe(save_dir)
    assert got == jax_compose(CONFIG_DIR, "config", chip_smoke.train_overrides(save_dir)).to_container()
    t = got["training"]
    assert (t["epochs"], t["batch_size"], t["eval_batch_size"], t["compute_dtype"], t["transfer_dtype"]) == (
        2, 8, 8, "bfloat16", "float16")
    assert t["optimizer"] == "adam" and t["optimizers"]["adam"]["lr"] == 1e-5
    assert t["scheduler"]["name"] == "poly" and t["eval_test"]["every_n_epochs"] == 1
    assert t["criterion"]["lambda_dice"] == 5.0 and t["criterion"]["ce_weight"] == [50.0]
    assert got["model"]["channels"] == [32, 64, 128, 256, 512] and got["task"]["seed"] == 0
    assert got["evaluation"]["surface"] == {"enable": True, "nsd_tol": 2.0}
