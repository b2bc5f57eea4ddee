"""Supervised segmentation trainer (the port of
``multimodal_tta_tpu/core/trainers/seg_trainer.py``).

The DiceCE (or GWDL) loss is built from ``training.criterion`` (softmax XOR
sigmoid, with the same validation) and labels are shape-checked per mode.
One step, on the trainer's device:

  - upcast the compact transfer dtype; modality dropout, then the per-sample
    intensity normalizer, then the intensity augmentation (as the
    ``SegTransform.device_spec()`` handed in asks)
  - forward in the model's compute dtype (bf16 with an f32 head for the
    flagship), the loss per sample averaged over the batch's valid samples,
    backward, the optimizer step (``TrainState.apply_gradients``)
  - ``model.deep_supervision = k``: the same loss on the sown ``ds{i}``
    logits against labels sliced ``::f`` (f the product of the first i
    strides) on the three spatial axes, weights ``2^-i`` normalized to sum
    1; ``model.moe_experts > 0``: ``model.moe_aux_weight * mean(aux)`` of
    the sown Switch aux losses, added after the masked mean;
    ``training.distill``: ``weight * kd_loss`` of the frozen teacher's
    logits on the same input, per sample before the mask. The model's
    forward runs inside ``capture_intermediates``; a model that sows no
    ``ds{i}`` or no ``moe_aux`` raises the reference's ``ValueError``
  - the EMA shadow (``training.ema``), ticked only on applied steps under
    ``training.grad_accum``

Metrics contract: the loss is read on the host one step late, so
``run_step`` returns the *previous* step's ``{"loss": float}`` (an empty
dict on the first step) and ``flush_step_metrics()`` drains the last one;
the host never waits on the step it has just launched.

The model runs its step in training mode (the reference's ``train=True``)
and is put back in the mode it had: a BatchNorm model normalizes with the
batch's statistics (padded rows included, as in the reference) and moves
its running statistics once a step, with remat or without.
``training.remat`` is the model's (``ExperimentManager`` builds it with it).
``training.debug_nans`` checks every module's outputs and the backward for
a NaN (``utils/debug_nans.py``).

Over ranks (``mesh``, ``parallel/mesh.py``) a step on rank ``r`` runs on its
rows of the padded global batch and equals one process's step on the global
batch: the draws (modality dropout, intensity augmentation) are made for
the global batch and sliced; the loss is the rank's masked sum over the
GLOBAL valid count; the MoE load balance pools its statistics over the
ranks and, being the same on every rank, enters each rank's loss divided
by the rank count; a BatchNorm pools its statistics
(``models/layers.py:pool_over_ranks``); after the backward the gradients
and the loss are SUMMED over the ranks in one ``all_reduce`` of a flat
buffer (no DDP wrapper, so the module keeps its names and a sum needs no
rescaling), and every rank applies the same update (with ``training.zero1``
each steps its partition of the optimizer state and the params are
broadcast).

Over a space axis (``mesh.space > 1``) rank ``(d, s)`` holds data rank
``d``'s rows and depth slab ``s``: the intensity transform and the model
run over the split depth (``parallel/space.py``), the per-sample loss is
the slab's CE over the whole volume's count plus ``1 / space`` of the Dice
(or GWDL) of the space group's sums, and the world's sum of the gradients
and the loss then holds every rank once. A deep-supervision level that is
whole is scored on the gathered labels and counted once (``_add_ds_terms``);
the MoE load balance is the same on every rank of the world and enters
each loss divided by ``data x space``; the teacher runs on the same slab
and the KD term is the slab's part.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ... import DeviceLike
from ...conf.node import ConfigNode
from ...data.prefetch import TRANSFER_DTYPES, prefetch_to_device
from ...models.layers import capture_intermediates
from ...models.moe import collect_moe_aux
from ...models.layers import pool_over_ranks
from ...ops.augment import (
    apply_intensity_scale_shift,
    apply_modality_dropout,
    intensity_scale_shift_draws,
    modality_dropout_draws,
)
from ...parallel import space as sp
from ...parallel.mesh import pad_batch_to_multiple
from ...parallel.tensor import shard_axes
from ...ops.intensity import make_intensity_normalizer
from ...ops.losses import make_criterion
from ...utils.config import get_config
from ...utils.debug_nans import check_nan, checked_backward, install_nan_hooks
from ..distill import DistillConfig, build_teacher, kd_loss
from ..train_state import shadow_module
from ..trainer_base import TrainerBase


class SegTrainer(TrainerBase):
    def __init__(self, config, evaluation_strategy=None, device_transform=None,
                 device: DeviceLike = "cuda", mesh=None):
        super().__init__(config, device, mesh)
        self.evaluation_strategy = evaluation_strategy

        crit_cfg = get_config(config, "training.criterion", ConfigNode())
        self.softmax = bool(get_config(crit_cfg, "softmax", False))
        self.sigmoid = bool(get_config(crit_cfg, "sigmoid", not self.softmax))
        if self.softmax and self.sigmoid:
            raise ValueError("[SegTrainer] softmax=True and sigmoid=True cannot both be True.")
        if not self.softmax and not self.sigmoid:
            raise ValueError("[SegTrainer] both softmax and sigmoid are False. Set one True.")
        self.space = sp.axis_of(self.mesh)
        self.loss_fn = make_criterion(crit_cfg)

        # nnU-Net-style deep supervision: the same loss on the model's aux
        # logits at the k next-coarser decoder levels, against strided
        # (nearest) labels, weights 1/2^k normalized to sum 1
        self.ds_levels = int(get_config(config, "model.deep_supervision", 0))
        self.strides = strides = [int(s) for s in get_config(config, "model.strides", [2, 2, 2, 2])]
        self.ds_factors = [math.prod(strides[:i]) for i in range(1, self.ds_levels + 1)]
        w = np.array([0.5**k for k in range(self.ds_levels + 1)], np.float64)
        self.ds_weights = [float(x) for x in w / w.sum()]

        # the Switch load-balance aux loss of routed-expert models
        self.moe_experts = int(get_config(config, "model.moe_experts", 0))
        self.moe_aux_weight = float(get_config(config, "model.moe_aux_weight", 0.01))
        # the last step's sown MoE scalars, detached, on the device
        self.moe_stats: Optional[Dict[str, torch.Tensor]] = None

        # knowledge distillation: parsed now, so a bad config fails at
        # bring-up; the teacher is built at the first step
        self.distill = DistillConfig(config)
        self.teacher: Optional[nn.Module] = None

        self.debug_nans = bool(get_config(config, "training.debug_nans", False))
        self._nan_hooked: set = set()

        # device-side transform spec (from SegTransform.device_spec())
        self.device_transform = device_transform or {}
        self._norm_fn = None
        if self.device_transform.get("normalize"):
            self._norm_fn = make_intensity_normalizer(
                normalize=True,
                intensity_policy=self.device_transform.get("intensity_policy"),
                channel_names=self.device_transform.get("channel_names"),
                mean=self.device_transform.get("mean"),
                std=self.device_transform.get("std"),
            )

        # compact H2D dtype for images (upcast to f32 on the device)
        td = str(get_config(config, "training.transfer_dtype", "float32")).lower()
        self._transfer_dtype = TRANSFER_DTYPES[td]

        ema_cfg = get_config(config, "training.ema", ConfigNode())
        self.ema_enabled = bool(get_config(ema_cfg, "enabled", False))
        self.ema_decay = float(get_config(ema_cfg, "decay", 0.999))
        self.ema_eval = bool(get_config(ema_cfg, "eval", True))
        if self.ema_enabled and not (0.0 < self.ema_decay < 1.0):
            raise ValueError(f"[SegTrainer] training.ema.decay must be in (0,1), got {self.ema_decay}")
        self._ema_module: Optional[nn.Module] = None

        self._gen = torch.Generator(device=self.device).manual_seed(int(get_config(config, "task.seed", 0)))
        self._pending_loss: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    def _step(self, image: torch.Tensor, label: torch.Tensor, n_valid: int) -> torch.Tensor:
        """One training step on device tensors; returns the loss (0-d, on the
        device, detached)."""
        dt = self.device_transform
        state = self.state
        image = image.to(torch.float32)  # upcast compact transfer dtypes
        # the global batch this rank holds ``rows`` of (one process: all of
        # it); the draws are the global batch's
        world = self.mesh.data
        n = image.shape[0] * world
        rows = self.mesh.rows(n)
        if dt.get("modality_dropout"):
            # before normalization, so training sees what deployment gives
            # for an absent modality: raw zeros through the normalizer
            drop = modality_dropout_draws(n, image.shape[-1], self._gen,
                                          prob=float(dt.get("modality_dropout_prob", 0.25)))
            image = apply_modality_dropout(image, drop[rows])
        if self._norm_fn is not None:
            image = self._norm_fn(image, space=self.space)
        if dt.get("intensity_aug"):
            factor, offset = intensity_scale_shift_draws(
                n, self._gen, scale=float(dt.get("int_scale", 0.1)), shift=float(dt.get("int_shift", 0.1)),
                prob=float(dt.get("int_prob", 0.5)))
            image = apply_intensity_scale_shift(image, factor[rows], offset[rows])

        lbl = label.to(torch.float32) if self.sigmoid else label.to(torch.int64)
        state.optimizer.zero_grad(set_to_none=True)
        was_training = state.model.training
        state.model.train()
        try:
            with sp.sharded(self.mesh), capture_intermediates(bool(self.ds_levels or self.moe_experts)) as inter:
                logits = state.model(image)
            per_sample = self._per_sample(logits, lbl, self.space)
            if self.ds_levels:
                missing = [f"ds{k + 1}" for k in range(self.ds_levels) if f"ds{k + 1}" not in inter]
                if missing:
                    raise ValueError(
                        f"[SegTrainer] model.deep_supervision={self.ds_levels} but the "
                        f"model sowed no {missing} intermediates — the selected "
                        "model does not implement deep supervision (models/"
                        "unet3d.py does; set model.deep_supervision=0 for others)"
                    )
                per_sample = self._add_ds_terms(self.ds_weights[0] * per_sample, inter, lbl)
            if self.distill.enabled:
                with torch.no_grad(), sp.sharded(self.mesh):  # the frozen teacher, on the input the student sees
                    t_logits = self.teacher(image)
                per_sample = per_sample + self.distill.weight * kd_loss(
                    logits, t_logits, sigmoid=self.sigmoid, temperature=self.distill.temperature,
                    focus=self.distill.focus, space=self.space)
            # samples past n_valid (a padded batch tail) are masked out;
            # the denominator is the global batch's valid count
            valid = (torch.arange(n, device=per_sample.device) < n_valid).to(torch.float32)
            loss = (per_sample * valid[rows]).sum() / torch.clamp(valid.sum(), min=1.0)
            if self.moe_experts:
                aux = collect_moe_aux(inter)
                if not aux:
                    raise ValueError(
                        "[SegTrainer] model.moe_experts > 0 but the model "
                        "sowed no moe_aux intermediates — the selected "
                        "model has no MoE layers (models/unetr.py "
                        "moe_experts does; set model.moe_experts=0 for "
                        "others)"
                    )
                # the same value on every rank: its share of the summed loss
                ranks = world * sp.space_size(self.space)
                loss = loss + self.moe_aux_weight * torch.stack(aux).mean() / ranks
                self.moe_stats = {"aux": torch.stack(aux).detach(),
                                  "dropped": torch.stack(inter["moe_dropped"]).detach()}
            # a rematerialized segment runs its forward again in the backward
            if self.debug_nans:
                check_nan(loss, "the training loss")
                checked_backward(loss)
            else:
                loss.backward()
        finally:
            state.model.train(was_training)
        loss = self._sum_over_ranks(loss.detach())
        applied = state.apply_gradients()
        # under training.grad_accum the params move on every k-th step only,
        # and the shadow ticks with them, not per microstep
        if self.ema_enabled and applied:
            self._update_ema()
        return loss

    def _sum_over_ranks(self, loss: torch.Tensor) -> torch.Tensor:
        """The params' gradients and ``loss`` summed over the ranks in one
        ``all_reduce`` of a flat buffer (the whole params' and the loss then
        averaged over a model or expert group: ``Mesh.sum_flat``); returns
        the global loss. Every rank has gradients for the same params (one
        graph), and a param without one stays without, as in one process."""
        named = [(n, p) for n, p in self.state.model.named_parameters() if p.grad is not None]
        params = [p for _, p in named]
        shards = shard_axes(self.state.model, [n for n, _ in named]) + [None]
        *grads, total = self.mesh.sum_flat([p.grad for p in params] + [loss.reshape(1).to(params[0].grad.dtype)],
                                           shards)
        for p, g in zip(params, grads):
            p.grad = g
        return total[0].to(loss.dtype)

    def _per_sample(self, logits: torch.Tensor, lbl: torch.Tensor, space=None) -> torch.Tensor:
        """The loss of each sample; ``space``: the logits and labels are this
        rank's depth slabs (each value the slab's part)."""
        kw = {} if space is None else {"space": space}
        return torch.stack([self.loss_fn(logits[i:i + 1], lbl[i:i + 1], **kw) for i in range(logits.shape[0])])

    def _add_ds_terms(self, per_sample: torch.Tensor, inter: dict, lbl: torch.Tensor) -> torch.Tensor:
        """``per_sample`` plus the weighted deep-supervision terms against labels
        sliced ``::f`` (nearest-downsampled: the label stays crisp). Over a
        space axis a split level's logits are this rank's slab, and so is
        its slab of the labels ``[::f]`` (a split level's slab length is a
        multiple of f); a whole level's logits are every rank's alike, so
        its term is taken from the gathered labels and counted once, as
        ``1 / space`` of it on each rank."""
        axes = sp.level_axes(self.space, lbl.shape[1], self.strides)
        whole_lbl = None
        for k, f in enumerate(self.ds_factors):
            aux_logits = inter[f"ds{k + 1}"][0]
            if self.space is not None and axes[k + 1] is None:
                if whole_lbl is None:
                    whole_lbl = sp.all_gather_cat(lbl, 1, self.space.size, self.space.group)
                term = self._per_sample(aux_logits, whole_lbl[:, ::f, ::f, ::f]) / self.space.size
            else:
                term = self._per_sample(aux_logits, lbl[:, ::f, ::f, ::f], self.space)
            per_sample = per_sample + self.ds_weights[k + 1] * term
        return per_sample

    def prepare(self) -> None:
        """Build the distillation teacher and hook the NaN checks (each
        once); ``run_step`` calls it before every step."""
        if self.distill.enabled and self.teacher is None:
            image_size = get_config(self.config, "training.data.transforms.image_size", None)
            if not image_size:
                raise ValueError(
                    "[distill] training.data.transforms.image_size is required "
                    "to initialize the teacher"
                )
            self.teacher = build_teacher(self.config, self.device, [int(x) for x in image_size])
            self.logger.info(
                f"[distill] teacher {get_config(self.distill.model, 'name')} "
                f"loaded from {self.distill.checkpoint} "
                f"(T={self.distill.temperature}, weight={self.distill.weight}, focus={self.distill.focus})"
            )
        if self.debug_nans:
            for tag, module in (("model", self.state.model), ("teacher", self.teacher)):
                if module is not None and id(module) not in self._nan_hooked:
                    install_nan_hooks(module, tag)
                    self._nan_hooked.add(id(module))

    @torch.no_grad()
    def _update_ema(self) -> None:
        d = self.ema_decay
        names = list(self.state.ema_params)
        params = dict(self.state.model.named_parameters())
        shadow = [self.state.ema_params[n] for n in names]
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, [params[n].detach() for n in names], alpha=1.0 - d)

    # ------------------------------------------------------------------
    def eval_state(self) -> nn.Module:
        """The module evaluation runs on: the live model, or with
        ``training.ema.eval`` a copy carrying the EMA shadow and the live
        running statistics (kept between calls; the live params and the
        optimizer's references to them are not touched)."""
        model = self.state.model
        if self.ema_enabled and self.ema_eval and self.state.ema_params is not None:
            self._ema_module = shadow_module(model, self.state.ema_params, into=self._ema_module)
            return self._ema_module
        return model

    # ------------------------------------------------------------------
    def _check_shapes(self, image, label) -> None:
        if self.softmax:
            if label.ndim != image.ndim - 1:
                raise ValueError(
                    f"[SegTrainer/softmax] Expect y as [B,spatial...] with ndim={image.ndim - 1}, "
                    f"got y={tuple(label.shape)}, image={tuple(image.shape)}."
                )
            if tuple(label.shape[1:]) != tuple(image.shape[1:-1]):
                raise ValueError(
                    f"[SegTrainer/softmax] Spatial mismatch: y={tuple(label.shape)} vs "
                    f"image={tuple(image.shape)}."
                )
        else:
            if label.ndim != image.ndim:
                raise ValueError(
                    f"[SegTrainer/sigmoid] Expect y as [B,spatial...,C] with ndim={image.ndim}, "
                    f"got y={tuple(label.shape)}. Dataset must output channel-last masks "
                    f"(binary => [B,...,1])."
                )
            if tuple(label.shape[:-1]) != tuple(image.shape[:-1]):
                raise ValueError(
                    f"[SegTrainer/sigmoid] Spatial mismatch: y={tuple(label.shape)} vs "
                    f"image={tuple(image.shape)}."
                )

    def setup(self, state, evaluation_strategy=None, scheduler=None):
        super().setup(state, evaluation_strategy, scheduler)
        pool_over_ranks(state.model, self.mesh)

    def _wrap_loader(self, loader):
        if getattr(loader, "device_resident", False):
            return loader  # batches already live on the device (this rank's rows)
        return prefetch_to_device(
            loader,
            self.device,
            image_transfer_dtype=self._transfer_dtype,
            label_transfer_dtype=torch.uint8 if self.sigmoid else None,
            mesh=self.mesh,
        )

    def run_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        image, label = batch["image"], batch["label"]
        self._check_shapes_meta(image, label)

        if "_n_valid" in batch:
            # already on the device (prefetch_to_device)
            n_valid = int(batch["_n_valid"])
        else:
            # the global host batch, padded to the data axis; this rank's rows
            padded, n_valid = pad_batch_to_multiple({"image": np.asarray(image, dtype=np.float32),
                                                     "label": np.asarray(label)}, self.mesh.data)
            image, label = self.mesh.local(padded["image"]), self.mesh.local(padded["label"])
            image = torch.as_tensor(image).to(self.device)
            label = torch.as_tensor(label).to(self.device)

        self.prepare()
        if self.ema_enabled and self.state.ema_params is None:
            # standard EMA init: the shadow starts at a copy of the params
            self.state.ema_params = {n: p.detach().clone() for n, p in self.state.model.named_parameters()}

        loss = self._step(image, label, n_valid)
        # read the previous step's loss: the host does not wait for this one
        prev = self._pending_loss
        self._pending_loss = loss
        return {"loss": float(prev)} if prev is not None else {}

    def flush_step_metrics(self):
        if self._pending_loss is None:
            return {}
        loss = float(self._pending_loss)
        self._pending_loss = None
        return {"loss": loss}

    def _check_shapes_meta(self, image, label) -> None:
        """Shape-contract checks on array metadata (no host transfer)."""

        class _V:
            def __init__(self, shape):
                self.shape = tuple(shape)
                self.ndim = len(shape)

        self._check_shapes(_V(image.shape), _V(label.shape))

    # ------------------------------------------------------------------
    def _is_best_model(self, eval_stats: Dict[str, float]) -> bool:
        """Delegate to the strategy's is_best_model, else min val loss
        (reference: seg_trainer.py:85-95)."""
        if hasattr(self.evaluation_strategy, "is_best_model"):
            return self.evaluation_strategy.is_best_model(eval_stats, self.best_metrics)
        if eval_stats:
            current = eval_stats.get("loss", 0.0)
            best = self.best_metrics.get("loss", float("inf"))
            self.logger.info(f"Current loss: {current:.4f}, Best loss: {best:.4f}")
            return current < best
        return False
