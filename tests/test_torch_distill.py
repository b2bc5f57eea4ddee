"""Parity of the port's distillation (``core/distill.py``, the KD term of
``SegTrainer``, ``core/checkpoint.py:load_params_only``) with the JAX
package.

  - ``kd_loss`` values within 1e-6 relative and its gradient against
    ``jax.grad`` within 1e-5 relative L2, sigmoid and softmax, ``focus``
    all and uncertain;
  - distilled ``SegTrainer`` steps (SGD) against the JAX ones, the JAX
    teacher read from its msgpack checkpoint and the port's from a ``.pt``
    file of the same weights at the same extension-less path (the sidecar
    names the ``.pt``; tests/test_torch_flax_msgpack.py reads the teacher
    from the JAX package's msgpack): the losses
    and params to ``tests/test_torch_seg_trainer.py``'s tolerances; the
    teacher frozen, in inference mode, bitwise unchanged, without optimizer
    state;
  - ``load_params_only`` with and without the EMA shadow; the misuse
    errors the reference raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.core import distill as jdistill
from multimodal_tta_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from multimodal_tta_tpu.core.train_state import TrainState as JaxTrainState
from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core import distill as tdistill
from multimodal_tta_tpu_torch.core.checkpoint import load_params_only, save_checkpoint
from multimodal_tta_tpu_torch.core.train_state import TrainState
from multimodal_tta_tpu_torch.models.convert import from_flax
from multimodal_tta_tpu_torch.models.unet3d import UNet3D
from tests._torch_port import (SGD, SMALL, SMALL_SHAPE, random_flax_params, trainer_config, trainer_pair,
                               assert_steps_match)
from tests.test_torch_seg_trainer import make_volumes

torch.set_num_threads(2)

TEACHER = dict(SMALL, channels=(4, 8, 16))
TEACHER_NODE = {"name": "unet", **{k: list(v) if isinstance(v, tuple) else v for k, v in TEACHER.items()}}


@pytest.mark.parametrize("focus", ["all", "uncertain"])
@pytest.mark.parametrize("sigmoid", [True, False])
def test_kd_loss_and_gradient(sigmoid, focus):
    rng = np.random.RandomState(1)
    shape = (3, 4, 6, 5, 1 if sigmoid else 3)
    s, t = (rng.randn(*shape).astype(np.float32) * 2 for _ in range(2))
    kw = dict(sigmoid=sigmoid, temperature=2.0, focus=focus)
    want = np.asarray(jdistill.kd_loss(jnp.asarray(s), jnp.asarray(t), **kw))
    want_g = np.asarray(jax.grad(lambda a: jnp.sum(jdistill.kd_loss(a, jnp.asarray(t), **kw)
                                                   * jnp.arange(1.0, 4.0)))(jnp.asarray(s)))
    st = torch.from_numpy(s).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    got = tdistill.kd_loss(st, tt, **kw)
    (got * torch.arange(1.0, 4.0)).sum().backward()
    assert got.shape == (3,) and tt.grad is None  # the teacher side carries no gradient
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7)
    assert np.linalg.norm(st.grad.numpy() - want_g) <= 1e-5 * np.linalg.norm(want_g)
    # zero where student and teacher agree
    assert float(tdistill.kd_loss(tt.detach(), tt.detach(), **kw).abs().max()) < 1e-6
    with pytest.raises(ValueError, match="unknown focus"):
        tdistill.kd_loss(st, tt, sigmoid=sigmoid, focus="edges")


def _teacher_files(tmp_path, params) -> str:
    """The same teacher weights as the reference's msgpack checkpoint and
    the port's .pt checkpoint, at one extension-less path."""
    path = str(tmp_path / "teacher")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jax_save_checkpoint(path, JaxTrainState.create(apply_fn=JaxUNet3D(**TEACHER).apply, params=jparams,
                                                   tx=optax.sgd(0.1)))
    model = UNet3D(**TEACHER, device="cpu")
    model.load_state_dict(from_flax(params), strict=True)
    save_checkpoint(path, TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1)), fmt="torch")
    return path


@pytest.mark.parametrize("focus", ["all", "uncertain"])
def test_distilled_steps_match_reference(tmp_path, focus):
    teacher_params = random_flax_params(JaxUNet3D(**TEACHER), (1,) + SMALL_SHAPE, seed=21)
    path = _teacher_files(tmp_path, teacher_params)
    distill = {"enabled": True, "checkpoint": path, "temperature": 2.0, "weight": 1.0, "focus": focus,
               "model": TEACHER_NODE}
    cfg = trainer_config(SGD, {})
    cfg["training"].update(distill=distill, data={"transforms": {"image_size": list(SMALL_SHAPE[:3])}})
    jm = JaxUNet3D(**SMALL)
    params = random_flax_params(jm, (1,) + SMALL_SHAPE, seed=22)
    jt, pt = trainer_pair(cfg, jm, UNet3D(**SMALL, device="cpu"), params)
    img, lbl = make_volumes(4, seed=15)
    batches = [{"image": img[i:i + 2], "label": lbl[i:i + 2]} for i in (0, 2)]
    losses = assert_steps_match(jt, pt, batches, f"distilled focus={focus}")
    teacher = pt.teacher
    assert not teacher.training and not any(p.requires_grad for p in teacher.parameters())
    want = from_flax(teacher_params)
    assert all(torch.equal(p, want[n]) for n, p in teacher.named_parameters())
    opt_params = {id(p) for g in pt.state.optimizer.param_groups for p in g["params"]}
    assert not opt_params & {id(p) for p in teacher.parameters()}
    # the KD term is in the objective: without it the first step's loss is smaller
    plain = trainer_pair(trainer_config(SGD, {}), jm, UNet3D(**SMALL, device="cpu"), params)[1]
    plain.run_step(batches[0])
    assert plain.flush_step_metrics()["loss"] < losses[0]


def test_load_params_only(tmp_path):
    model = UNet3D(**SMALL, device="cpu", seed=1)
    opt = torch.optim.Adam(model.parameters())
    ema = {n: p.detach() + 1.0 for n, p in model.named_parameters()}
    save_checkpoint(str(tmp_path / "with_ema"), TrainState(model=model, optimizer=opt, ema_params=ema))
    save_checkpoint(str(tmp_path / "plain"), TrainState(model=model, optimizer=opt))
    other = UNet3D(**SMALL, device="cpu", seed=2)
    assert load_params_only(str(tmp_path / "plain"), other) is other
    assert all(torch.equal(a, b) for a, b in zip(other.state_dict().values(), model.state_dict().values()))
    load_params_only(str(tmp_path / "with_ema"), other, use_ema=True)
    assert all(torch.equal(p, ema[n]) for n, p in other.named_parameters())
    with pytest.raises(ValueError, match="carries no ema_params"):
        load_params_only(str(tmp_path / "plain"), other, use_ema=True)
    # both files are msgpack (the default); a .pt loads as well, and an
    # orbax checkpoint alone raises the reference's ValueError
    save_checkpoint(str(tmp_path / "pt"), TrainState(model=model, optimizer=opt), fmt="torch")
    load_params_only(str(tmp_path / "pt"), other)
    assert all(torch.equal(a, b) for a, b in zip(other.state_dict().values(), model.state_dict().values()))
    save_checkpoint(str(tmp_path / "old"), TrainState(model=model, optimizer=opt), fmt="orbax")
    with pytest.raises(ValueError, match="is orbax-format; params-only loading needs the msgpack format"):
        load_params_only(str(tmp_path / "old"), other)
    with pytest.raises(FileNotFoundError):
        load_params_only(str(tmp_path / "absent"), other)


@pytest.mark.parametrize("distill", [
    {"enabled": True},
    {"enabled": True, "checkpoint": "/nonexistent/x"},
    {"enabled": True, "checkpoint": "/nonexistent/x", "weight": 0.0, "model": TEACHER_NODE},
    {"enabled": True, "checkpoint": "/nonexistent/x", "temperature": -1.0, "model": TEACHER_NODE},
    {"enabled": True, "checkpoint": "/nonexistent/x", "focus": "edges", "model": TEACHER_NODE},
])
def test_distill_config_errors_match_reference(distill):
    node = {"training": {"distill": distill}}
    raised = []
    for cls, cfg_cls in ((jdistill.DistillConfig, JaxConfigNode), (tdistill.DistillConfig, ConfigNode)):
        with pytest.raises((KeyError, ValueError)) as err:
            cls(cfg_cls(node))
        raised.append((err.type, str(err.value)))
    assert raised[0] == raised[1]
    assert not tdistill.DistillConfig(ConfigNode({"training": {}})).enabled
