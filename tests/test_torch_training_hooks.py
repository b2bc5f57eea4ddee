"""The port's ``training.profile`` (``core/hooks.py:ProfilerHook``) and
``training.debug_nans`` (``utils/debug_nans.py``) on the CPU.

  - the profiler traces steps ``[start_step, start_step + num_steps)``
    through ``ExperimentManager`` and ``TrainerBase.train``: a Chrome trace
    in ``log_dir`` with one ``ProfilerStep#k`` range per trained step, and a
    run that ends early stops it in ``after_train``;
  - ``debug_nans``: a batch with a NaN raises ``FloatingPointError`` naming
    the first module whose output holds one; a NaN from a backward node
    raises, naming the node; an Inf passes (``jax_debug_nans`` does not
    catch Inf either); on clean batches the params and losses are bitwise
    those of the run with the flag off.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.core.experiment_manager import ExperimentManager
from multimodal_tta_tpu_torch.data import HostLoader
from multimodal_tta_tpu_torch.utils.debug_nans import checked_backward, install_nan_hooks
from tests._torch_port import DEVICE_TRANSFORM, SGD, SMALL, trainer_config
from tests.test_torch_seg_trainer import make_volumes

torch.set_num_threads(2)


def manager(tmp_path, **training) -> ExperimentManager:
    cfg = trainer_config(dict(SGD, batch_size=2, **training),
                         {"name": "unet", **{k: list(v) if isinstance(v, tuple) else v for k, v in SMALL.items()}},
                         task={"seed": 0, "name": "hecktor21_seg", "save_dir": str(tmp_path)})
    m = ExperimentManager(ConfigNode(cfg), device="cpu")
    m.setup_model()
    m.setup_optimizer()
    img, lbl = make_volumes(8, seed=16)
    m.train_loader = HostLoader([{"image": i, "label": l} for i, l in zip(img, lbl)], batch_size=2)
    m.device_transform = DEVICE_TRANSFORM
    m.setup_trainer(str(tmp_path))
    return m


def profiler_steps(path: str) -> list:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({e["name"] for e in events if str(e.get("name", "")).startswith("ProfilerStep#")})


@pytest.mark.parametrize("start,num,want", [(1, 2, 2), (2, 10, 2)])
def test_profiler_traces_the_chosen_steps(tmp_path, start, num, want):
    """4 steps: steps 1-2 traced and the trace written after step 2; or
    from step 2 with 10 asked, the run ends after 2 and ``after_train``
    writes them."""
    m = manager(tmp_path, profile={"enabled": True, "start_step": start, "num_steps": num})
    hook = m.profiler_hook
    assert hook.log_dir == os.path.join(str(tmp_path), "profile")
    m.train(1)
    assert m.trainer.iter == 4 and hook.trace_path is not None and os.path.dirname(hook.trace_path) == hook.log_dir
    assert len(profiler_steps(hook.trace_path)) == want
    with open(hook.trace_path) as f:  # the trained steps' ops are in it
        assert "aten::convolution" in f.read()


def test_debug_nans_raises_on_a_nan_and_changes_nothing_else(tmp_path):
    runs = {}
    for flag in (False, True):
        m = manager(tmp_path / str(flag), debug_nans=flag)
        img, lbl = make_volumes(4, seed=17)
        for i in (0, 2):
            m.trainer.run_step({"image": img[i:i + 2], "label": lbl[i:i + 2]})
        runs[flag] = (m.trainer.flush_step_metrics()["loss"],
                      {n: p.detach().clone() for n, p in m.model.named_parameters()}, m)
    assert runs[True][0] == runs[False][0]
    assert all(torch.equal(p, runs[False][1][n]) for n, p in runs[True][1].items())
    m = runs[True][2]
    img, lbl = make_volumes(2, seed=18)
    img[1, 3, 4, 5, 1] = np.nan
    with pytest.raises(FloatingPointError, match=r"NaN in the output of model\.enc0"):
        m.trainer.run_step({"image": img, "label": lbl})
    # with the flag off the same batch trains on, to a NaN loss
    off = runs[False][2]
    off.trainer.run_step({"image": img, "label": lbl})
    assert np.isnan(off.trainer.flush_step_metrics()["loss"])


class Sqrt(nn.Module):
    def forward(self, x):
        return torch.sqrt(x)


def test_debug_nans_backward_and_inf():
    # sqrt(0) has an infinite derivative: times the upstream 0 it is a NaN in the backward only
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="SqrtBackward0"):
        checked_backward((Sqrt()(x) * 0.0).sum())
    # an Inf passes, forward and backward
    m = Sqrt()
    install_nan_hooks(m)
    y = torch.tensor([1e30, 2.0], requires_grad=True)
    out = m(y) * torch.tensor([float("inf"), 1.0])
    checked_backward((out * 1e30).sum())
    assert torch.isinf(out).any() and torch.isinf(y.grad).any() and not torch.isnan(y.grad).any()
    with pytest.raises(FloatingPointError, match=r"NaN in the output of model \(Sqrt\)"):
        m(torch.tensor([-1.0]))


def test_chip_smoke_phase20_at_fixture_size(tmp_path):
    """chip_smoke's phase 20 (``training_options_phase``) on the CPU at
    narrow widths: every run of ``OPTION_RUNS`` and the debug_nans check,
    the launches as the phase derives them (norm calls counted by a module
    hook)."""
    import chip_smoke
    from multimodal_tta_tpu_torch.core.checkpoint import save_checkpoint
    from multimodal_tta_tpu_torch.core.train_state import TrainState
    from multimodal_tta_tpu_torch.models.unet3d import UNet3D
    from tests._torch_port import NormCalls

    narrow = ["model.channels=[2,4,8,16,32]"]
    teacher = UNet3D(channels=(2, 4, 8, 16, 32), device="cpu", seed=9)
    save_checkpoint(str(tmp_path / "teacher"), TrainState(model=teacher, optimizer=torch.optim.SGD(
        teacher.parameters(), lr=0.1)))
    shape = (16, 32, 32)
    calls = NormCalls()
    try:
        out = chip_smoke.training_options_phase(
            "cpu", str(tmp_path / "options"), str(tmp_path / "teacher"), shape=shape,
            small={"unet": shape, "unet_ws": shape, "unetr": shape}, teacher_extra=narrow,
            extra={"unet": narrow, "unet_ws": narrow, "unetr": ["model.hidden_size=32", "model.mlp_dim=64",
                                                                "model.num_heads=2", "model.feature_size=4"]},
            reset_counts=calls.reset, read_counts=calls.read, warm_steps=2)
    finally:
        calls.remove()
    runs = out["runs"]
    assert list(runs) == [r[0] for r in chip_smoke.OPTION_RUNS]
    assert runs["A_unetr_moe8_adafactor"]["optimizer"] == "Adafactor"
    assert runs["A_unetr_moe8_adam"]["moe_layers"] == 6 and runs["D_unet_moe8"]["moe_layers"] == 1
    assert runs["A_unetr_moe8_adam"]["step_want"] == {"forward": 16 + 10, "backward": 16}
    assert runs["C_unet_ws_distill_all"]["step_want"] == {"forward": 16 + 18, "backward": 16}
    assert runs["C_unet_ws_distill_uncertain"]["teacher_bitwise_checkpoint"]
    assert runs["D_unet_moe8"]["profile"]["profiler_steps"] == ["ProfilerStep#0", "ProfilerStep#1"]
    assert all(r["steps"] == 4 and r["val_batches"] == 2 for r in runs.values())
    assert (runs["A_unetr_moe8_adafactor"]["optimizer_state_bytes"]
            < runs["A_unetr_moe8_adam"]["optimizer_state_bytes"])
    assert out["debug_nans"]["clean_steps_bitwise_flag_off"] and "NaN" in out["debug_nans"]["raised"]
