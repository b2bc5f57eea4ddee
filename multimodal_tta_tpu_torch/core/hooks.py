"""Training hooks (the port of ``multimodal_tta_tpu/core/hooks.py``).

Timer, Checkpoint, MemoryMonitor, MetricsLogger and EarlyStopping. The
trainer steps the learning rate itself, once per epoch, so the reference's
no-op scheduler hook has no counterpart; the profiler hook is not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from ..utils.logger import get_logger
from .checkpoint import load_checkpoint, save_checkpoint
from .trainer_base import HookBase


class TimerHook(HookBase):
    def before_train(self):
        self.start_time = time.time()

    def after_train(self):
        elapsed = time.time() - self.start_time
        self.trainer.logger.info(f"Total training time: {elapsed:.2f} seconds")

    def before_train_epoch(self):
        self.epoch_start_time = time.time()

    def after_train_epoch(self):
        elapsed = time.time() - self.epoch_start_time
        self.trainer.logger.info(f"Epoch {self.trainer.epoch} took {elapsed:.2f} seconds")


class CheckpointHook(HookBase):
    """Periodic + best-on-val checkpointing.

    State saved: epoch, TrainState (model, optimizer, step, EMA shadow),
    scheduler state, best_metrics. ``fmt`` is ``"torch"``. ``"msgpack"``,
    the reference's single-file format and the stock configs' choice
    (``configs/training/default.yaml``), writes the port's single-file
    ``.pt`` format instead, and says so once; the sharded orbax format is
    not ported (ROADMAP.md)."""

    def __init__(self, save_dir: str, save_freq: int = 1, save_start: int = 10, fmt: str = "torch"):
        self.save_dir = save_dir
        self.save_freq = int(save_freq)
        self.save_start = int(save_start)
        fmt = str(fmt).lower()
        if fmt == "msgpack":
            get_logger().info(
                "[CheckpointHook] training.checkpoint_format=msgpack: the port writes its "
                "single-file .pt format (path.pt + path.json) in its place")
            fmt = "torch"
        if fmt in ("orbax", "sharded"):
            raise NotImplementedError(
                f"[CheckpointHook] the {fmt} checkpoint format is not ported "
                "(ROADMAP.md, training slice left-overs); use training.checkpoint_format=torch")
        if fmt != "torch":
            raise ValueError(f"[CheckpointHook] unknown checkpoint format: {fmt}")
        self.fmt = fmt
        os.makedirs(self.save_dir, exist_ok=True)

    def after_train_epoch(self):
        epoch = self.trainer.epoch
        if (epoch + 1) % self.save_freq == 0 and epoch + 1 >= self.save_start:
            self.save(epoch, is_best=False)

    def after_val(self, is_best: bool):
        if is_best:
            self.save(self.trainer.epoch, is_best=True)
            self.trainer.logger.info("Best model saved based on validation metrics.")

    def save(self, epoch: int, is_best: bool):
        name = "best_model" if is_best else f"checkpoint_epoch_{epoch}"
        path = os.path.join(self.save_dir, name)
        extra = {
            "epoch": int(epoch),
            "best_metrics": dict(self.trainer.best_metrics),
        }
        if self.trainer.scheduler is not None:
            extra["scheduler"] = self.trainer.scheduler.state_dict()
        save_checkpoint(path, self.trainer.state, extra)
        self.trainer.logger.info(f"Checkpoint saved to {path}")

    def load(self, path: str) -> int:
        """Restore trainer state; returns the epoch to resume from."""
        if not any(os.path.exists(path + s) for s in ("", ".pt", ".msgpack", ".orbax")):
            self.trainer.logger.warning(f"Checkpoint not found at {path}, starting from scratch.")
            return 0
        state, extra = load_checkpoint(path, self.trainer.state)
        self.trainer.state = state
        self.trainer.best_metrics = dict(extra.get("best_metrics", {}))
        if self.trainer.scheduler is not None and "scheduler" in extra:
            self.trainer.scheduler.load_state_dict(extra["scheduler"])
        start_epoch = int(extra.get("epoch", -1)) + 1
        self.trainer.logger.info(f"Checkpoint loaded from {path}, resuming from epoch {start_epoch}")
        return start_epoch


class MemoryMonitorHook(HookBase):
    """Logs the CUDA allocator's bytes in use and the card's total every N
    steps (the reference's allocated/reserved MB)."""

    def __init__(self, every_n: int = 100):
        self.every_n = int(every_n)

    def after_train_step(self):
        if self.trainer.iter % self.every_n != 0 or self.trainer.device.type != "cuda":
            return
        dev = self.trainer.device
        used = torch.cuda.memory_allocated(dev) / 1024**2
        total = torch.cuda.get_device_properties(dev).total_memory / 1024**2
        self.trainer.logger.debug(f"Device memory: in_use={used:.2f}MB, limit={total:.2f}MB")


class MetricsLoggerHook(HookBase):
    """Formatted epoch summaries."""

    def __init__(self, log_every_n_epochs: int = 1):
        self.log_every_n_epochs = int(log_every_n_epochs)

    def on_epoch_end(self, epoch, train_stats, eval_stats, is_best):
        if epoch % self.log_every_n_epochs != 0:
            return
        train_str = self._fmt("Train", train_stats)
        eval_str = self._fmt("Eval", eval_stats)
        self.trainer.logger.info(f"Epoch {epoch}: {train_str} | {eval_str}")
        if is_best and eval_stats:
            key, value = next(iter(eval_stats.items()))
            self.trainer.logger.info(f"New best model: {key}: {value:.4f}")

    @staticmethod
    def _fmt(prefix: str, metrics: Dict[str, float]) -> str:
        if not metrics:
            return f"{prefix}: No metrics"
        parts = []
        for key, value in metrics.items():
            if key == "lr":
                parts.append(f"LR: {value:.6f}")
            else:
                parts.append(f"{key.replace('_', ' ').title()}: {value:.4f}")
        return f"{prefix}: {', '.join(parts)}"


class EarlyStoppingHook(HookBase):
    """Stops training when the monitored eval metric stops improving, by
    raising StopIteration, which TrainerBase.train catches as a clean early
    stop (the ``training.early_stopping`` config block)."""

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        patience: int = 10,
        min_delta: float = 0.0,
    ):
        self.metric = metric
        self.mode = mode
        self.patience = int(patience)
        self.min_delta = float(min_delta)
        self.best: Optional[float] = None
        self.bad = 0

    def on_epoch_end(self, epoch, train_stats, eval_stats, is_best):
        if not eval_stats or self.metric not in eval_stats:
            return
        value = float(eval_stats[self.metric])
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best - self.min_delta)
            or (self.mode == "max" and value > self.best + self.min_delta)
        )
        if improved:
            self.best = value
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                raise StopIteration(
                    f"early stopping: no {self.metric} improvement for {self.bad} evals"
                )
