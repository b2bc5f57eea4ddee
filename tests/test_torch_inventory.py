"""The port's inventory against the JAX package's, and what the port may
import.

  - every registry of ``multimodal_tta_tpu/registry.py`` holds the same names
    in the port's, every subpackage's ``__all__`` (``ops.__all__`` first among
    them) has its counterpart, and every module file has one (``pallas/`` is
    the port's ``kernels/``); ``utils/jax_setup.py``, which sets JAX's own
    platform environment, which the port has none of, is the only
    exception;
  - no module of ``multimodal_tta_tpu_torch/``, no ``scripts/torch_*.py``,
    not ``chip_smoke.py`` and not the ranks' helper
    ``tests/_torch_dp_worker.py`` imports ``jax``, ``flax``, ``optax``,
    ``msgpack``, ``orbax``, ``tensorstore``, ``zstandard`` or the JAX
    package (parsed with ``ast``;
    ``multimodal_tta_tpu_torch`` is not ``multimodal_tta_tpu``);
  - every CLI's ``main`` defaults to ``device="cuda"`` and raises without a
    card."""

import ast
import glob
import importlib
import inspect
import os

import pytest
import torch

import multimodal_tta_tpu.registry as jax_registry
import multimodal_tta_tpu_torch.registry as port_registry

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "msgpack", "orbax", "tensorstore", "zstandard", "multimodal_tta_tpu")
SUBPACKAGES = ("conf", "core", "data", "evaluation", "models", "ops", "parallel", "serving", "tta", "utils")
NOT_PORTED = {"utils/jax_setup.py": "JAX's platform environment"}  # module of the JAX package -> why


@pytest.mark.parametrize("kind", sorted(jax_registry._KINDS.values()))
def test_registries_hold_the_same_names(kind):
    for pkg in ("models", "data", "evaluation", "tta"):
        importlib.import_module(f"multimodal_tta_tpu.{pkg}")
        importlib.import_module(f"multimodal_tta_tpu_torch.{pkg}")
    want = jax_registry._REGISTRIES[kind].list_all()
    assert sorted(port_registry._REGISTRIES[kind].list_all()) == sorted(want)


@pytest.mark.parametrize("pkg", SUBPACKAGES)
def test_subpackages_export_the_same_names(pkg):
    want = set(importlib.import_module(f"multimodal_tta_tpu.{pkg}").__all__)
    port = importlib.import_module(f"multimodal_tta_tpu_torch.{pkg}")
    missing = sorted(want - set(getattr(port, "__all__", ())))
    assert not missing, f"multimodal_tta_tpu_torch.{pkg} lacks {missing}"
    assert all(hasattr(port, name) for name in port.__all__)


def test_every_module_has_its_counterpart():
    jax_root = os.path.join(REPO_ROOT, "multimodal_tta_tpu")
    port_root = os.path.join(REPO_ROOT, "multimodal_tta_tpu_torch")
    missing = []
    for path in sorted(glob.glob(os.path.join(jax_root, "**", "*.py"), recursive=True)):
        rel = os.path.relpath(path, jax_root)
        if rel in NOT_PORTED:
            continue
        if not os.path.isfile(os.path.join(port_root, rel.replace("pallas/", "kernels/"))):
            missing.append(rel)
    assert not missing


def _imports(path):
    """The module names a source file imports (absolute imports only)."""
    for node in ast.walk(ast.parse(open(path, encoding="utf-8").read(), filename=path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_the_port_imports_no_jax():
    files = (glob.glob(os.path.join(REPO_ROOT, "multimodal_tta_tpu_torch", "**", "*.py"), recursive=True)
             + glob.glob(os.path.join(REPO_ROOT, "scripts", "torch_*.py"))
             + [os.path.join(REPO_ROOT, "chip_smoke.py"), os.path.join(REPO_ROOT, "tests", "_torch_dp_worker.py")])
    assert len(files) > 80
    bad = {os.path.relpath(f, REPO_ROOT): names for f in files if (names := [n for n in _imports(f) if _forbidden(n)])}
    assert not bad
    assert _forbidden("multimodal_tta_tpu.ops") and _forbidden("flax.linen")
    assert not _forbidden("multimodal_tta_tpu_torch.ops") and not _forbidden("jaxlike")


CLI_ARGV = {"serve_artifact": ["--artifact", "a.mttap", "--manifest", "m.csv", "--out", "{tmp}"],
            "prepare_hecktor21": ["--config", "c.yaml"], "prepare_brats": ["--config", "c.yaml"]}


@pytest.mark.parametrize("name", sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(REPO_ROOT, "multimodal_tta_tpu_torch", "cli", "*.py")) if not p.endswith("__init__.py")))
def test_cli_defaults_to_cuda_and_raises_without_a_card(name, tmp_path):
    cli = importlib.import_module(f"multimodal_tta_tpu_torch.cli.{name}")
    assert inspect.signature(cli.main).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        argv = [a.format(tmp=tmp_path) for a in CLI_ARGV.get(name, [])]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
