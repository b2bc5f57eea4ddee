"""Knowledge distillation: a frozen teacher guides the supervised step (the
port of ``multimodal_tta_tpu/core/distill.py``).

``kd_loss`` is the per-sample Hinton loss, ``DistillConfig`` parses
``training.distill`` with the reference's checks, and ``build_teacher``
builds the teacher through the model registry from
``training.distill.model`` at ``training.compute_dtype`` and loads its
params (and buffers) from ``training.distill.checkpoint``: a ``.msgpack``
checkpoint, the reference's format, written by the JAX package or the
port, or the port's ``.pt`` (``core/checkpoint.py:load_params_only``). The
teacher is in inference mode, frozen (``requires_grad_(False)``), holds no optimizer state and runs
under ``torch.no_grad()`` in ``SegTrainer``'s step, on the student's
normalized and augmented input. Over a space axis the teacher runs on the
same depth slab inside the same ``space.sharded(mesh)``, over the axis
itself.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike
from ..conf.node import ConfigNode
from ..parallel.space import space_size, space_sum
from ..utils.config import get_config, require_config


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor, *, sigmoid: bool = True,
            temperature: float = 2.0, focus: str = "all", space=None) -> torch.Tensor:
    """Per-sample [B] KD loss ``T^2 * KL(teacher_T || student_T)`` of NDHWC
    logits: a Bernoulli KL per voxel and channel (sigmoid) or a categorical
    KL over the channel axis (softmax). ``focus="uncertain"`` weights each
    voxel by the teacher's softened prediction entropy, normalized per
    sample; ``"all"`` takes the plain mean. The teacher side carries no
    gradient. Over a space axis (``space``; the logits this rank's depth
    slab) the value is the slab's part: its sum over the whole volume's
    count, or over the space group's sum of the weights."""
    t = float(temperature)
    ls = student_logits / t
    lt = teacher_logits.detach() / t
    if sigmoid:
        pt = torch.sigmoid(lt)
        # KL(pt || ps) per voxel-channel, in logit form for stability
        kl = pt * (F.logsigmoid(lt) - F.logsigmoid(ls)) + (1.0 - pt) * (F.logsigmoid(-lt) - F.logsigmoid(-ls))
        h_t = -(pt * F.logsigmoid(lt) + (1.0 - pt) * F.logsigmoid(-lt))
    else:
        logpt = torch.log_softmax(lt, dim=-1)
        logps = torch.log_softmax(ls, dim=-1)
        kl = (logpt.exp() * (logpt - logps)).sum(dim=-1)
        h_t = -(logpt.exp() * logpt).sum(dim=-1)
    reduce_dims = tuple(range(1, kl.dim()))
    if focus == "uncertain":
        w = h_t.detach()
        num = (kl * w).sum(dim=reduce_dims)
        den = torch.clamp(space_sum(w.sum(dim=reduce_dims), space), min=1e-12)
        return (t * t) * num / den
    if focus != "all":
        raise ValueError(f"[distill] unknown focus: {focus}")
    if space is not None:
        return (t * t) * kl.sum(dim=reduce_dims) / float(kl[0].numel() * space_size(space))
    return (t * t) * kl.mean(dim=reduce_dims)


class DistillConfig:
    """Parsed ``training.distill`` block."""

    def __init__(self, config):
        node = get_config(config, "training.distill", ConfigNode())
        self.enabled = bool(get_config(node, "enabled", False))
        if not self.enabled:
            return
        self.checkpoint = str(require_config(node, "checkpoint", type_=str))
        self.temperature = float(get_config(node, "temperature", 2.0))
        self.weight = float(get_config(node, "weight", 1.0))
        if self.temperature <= 0:
            raise ValueError("[distill] training.distill.temperature must be > 0")
        if self.weight <= 0:
            raise ValueError(
                "[distill] training.distill.weight must be > 0 — set "
                "training.distill.enabled=false to train without a teacher"
            )
        # serve the teacher's EMA shadow instead of its raw params (the
        # checkpoint must carry one; same contract as training.use_ema_params)
        self.use_ema = bool(get_config(node, "use_ema_params", False))
        self.focus = str(get_config(node, "focus", "all")).lower()
        if self.focus not in ("all", "uncertain"):
            raise ValueError(f"[distill] unknown focus: {self.focus}")
        # the teacher's model node (name + arch keys); required, so that a
        # missing teacher never silently self-distills
        self.model = require_config(node, "model")
        require_config(self.model, "name", type_=str)


def build_teacher(config, device: DeviceLike, image_size: Sequence[int]) -> nn.Module:
    """The frozen teacher: built from ``training.distill.model`` through the
    registry (an input-sized model gets ``image_size`` (D, H, W)), its
    params and buffers loaded from ``training.distill.checkpoint``."""
    from ..registry import get_model
    from .checkpoint import load_params_only
    from .experiment_manager import compute_dtype_of

    dc = DistillConfig(config)
    model_cls = get_model(str(require_config(dc.model, "name", type_=str)))
    sized = {"image_size": list(image_size)} if getattr(model_cls, "input_sized", False) else {}
    teacher = model_cls.from_config(dc.model, dtype=compute_dtype_of(config), device=device, **sized)
    load_params_only(dc.checkpoint, teacher, use_ema=dc.use_ema)
    teacher.eval()
    teacher.requires_grad_(False)
    return teacher


__all__ = ["kd_loss", "DistillConfig", "build_teacher"]
