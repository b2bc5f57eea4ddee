"""Trainer base: epoch lifecycle, hooks, eval/test scheduling (the port of
``multimodal_tta_tpu/core/trainer_base.py``).

The reference trainer's semantics: 0-based epoch schedule with
start_epoch/every_n_epochs/run_last, per-epoch metric meters, best-model
tracking via the evaluation strategy, early stop through StopIteration, hooks
at the same lifecycle points in the same order, an epoch-stepped learning
rate, NaN loss for a zero-batch epoch, and the returned
``{train_history, eval_history}`` dict. Progress goes to the logger (the
reference draws progress bars). Over ranks (``mesh``) every rank runs the
same schedule on its rows, and evaluation returns the global metrics on
every rank, so the hooks decide alike everywhere.
"""

from __future__ import annotations

import weakref
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Tuple

from .. import DeviceLike, resolve_device
from ..parallel.mesh import Mesh
from ..utils.config import get_config
from ..utils.logger import get_logger
from ..utils.metrics import AverageMeter
from .optim import get_learning_rate, set_learning_rate


class HookBase:
    """Lifecycle hook.

    Nine no-op lifecycle points, overridable individually:
    before_train / after_train / before_train_epoch / after_train_epoch /
    before_train_step / after_train_step / before_val / after_val(is_best) /
    on_epoch_end(epoch, train_stats, eval_stats, is_best), plus state_dict()
    for checkpointable hook state. All default bodies share one no-op — a
    subclass overrides only the events it cares about.
    """

    trainer: "TrainerBase" = None

    def _noop(self, *args, **kwargs):
        return None

    before_train = after_train = _noop
    before_train_epoch = after_train_epoch = _noop
    before_train_step = after_train_step = _noop
    before_val = _noop
    after_val = _noop  # after_val(is_best)
    on_epoch_end = _noop  # on_epoch_end(epoch, train_stats, eval_stats, is_best)

    def state_dict(self) -> Dict[str, Any]:
        return {}


class TrainerBase(ABC):
    def __init__(self, config, device: DeviceLike = "cuda", mesh=None):
        self.config = config
        self.device = resolve_device(device)
        self.logger = get_logger()
        # the data axis over ranks (one process: a mesh of one rank)
        self.mesh = mesh if mesh is not None else Mesh(self.device)

        self.epoch = 0
        self.iter = 0
        self.start_epoch = 0
        self.best_metrics: Dict[str, float] = {}

        self.state = None  # TrainState, set by setup()
        self.evaluation_strategy = None
        self.scheduler = None  # EpochScheduler

        self._hooks: List[HookBase] = []
        self._last_val_loss: Optional[float] = None

    # ------------------------------------------------------------------
    def setup(self, state, evaluation_strategy=None, scheduler=None):
        self.state = state
        self.evaluation_strategy = evaluation_strategy
        self.scheduler = scheduler
        self.logger.info("Trainer wired (model/optimizer/eval strategy attached)")

    def register_hooks(self, hooks: List[HookBase]):
        hooks = [h for h in hooks if h is not None]
        for h in hooks:
            if not isinstance(h, HookBase):
                raise TypeError(f"hooks must be HookBase instances, got {type(h).__name__}")
            h.trainer = weakref.proxy(self)
        self._hooks.extend(hooks)
        self.logger.info(f"Registered {len(hooks)} hooks")

    def _emit(self, event: str, *args) -> None:
        """Fire one lifecycle event on every registered hook, in order."""
        for h in self._hooks:
            getattr(h, event)(*args)

    # ------------------------------------------------------------------
    def _should_run_eval_test(self, epoch: int, epochs: int) -> bool:
        start_epoch = int(get_config(self.config, "training.eval_test.start_epoch", 0))
        every_n = get_config(self.config, "training.eval_test.every_n_epochs", 1)
        run_last = bool(get_config(self.config, "training.eval_test.run_last", True))
        if every_n is None or int(every_n) <= 0:
            every_n = 1
        should = (epoch >= start_epoch) and ((epoch - start_epoch) % int(every_n) == 0)
        if run_last and epoch == epochs - 1:
            should = True
        return should

    # ------------------------------------------------------------------
    def train(
        self,
        epochs: int,
        train_loader,
        val_loader=None,
        test_loader=None,
        eval_on_train: bool = False,
    ) -> Dict[str, List]:
        self.logger.info(f"Training: {epochs} epoch(s) scheduled")
        train_history: List[Dict[str, float]] = []
        eval_history: List[Dict[str, float]] = []

        self._emit("before_train")

        do_val = bool(get_config(self.config, "training.eval_test.do_val", True))
        do_test = bool(get_config(self.config, "training.eval_test.do_test", False))

        try:
            for epoch in range(self.start_epoch, epochs):
                self.epoch = epoch

                train_stats = self.train_epoch(epoch, train_loader)
                train_history.append(train_stats)

                should_run = self._should_run_eval_test(epoch, epochs)

                eval_stats: Dict[str, float] = {}
                is_best = False
                if should_run and do_val and val_loader is not None:
                    eval_stats, is_best = self.evaluate(epoch, val_loader)
                    if "loss" in eval_stats:
                        self._last_val_loss = float(eval_stats["loss"])
                eval_history.append(eval_stats)

                if train_loader is not None and eval_on_train:
                    if epoch > 0 and epoch % 10 == 0:
                        self.eval_on_train(epoch, train_loader)

                if should_run and do_test and test_loader is not None:
                    self.test(epoch, test_loader)

                self._emit("on_epoch_end", epoch, train_stats, eval_stats, is_best)

                if eval_stats.get("loss") is not None:
                    self.logger.info(
                        f"Epoch {epoch + 1}/{epochs} completed. Train loss: {train_stats.get('loss')}, "
                        f"Val loss: {eval_stats.get('loss')}"
                    )
                else:
                    self.logger.info(f"Epoch {epoch + 1}/{epochs} done (train loss {train_stats.get('loss')})")

        except StopIteration as e:
            self.logger.info(f"Early stop raised mid-training: {e}")
        finally:
            self._emit("after_train")

        self.logger.info("Training loop finished")
        return {"train_history": train_history, "eval_history": eval_history}

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int, data_loader) -> Dict[str, float]:
        if self.state is None:
            raise RuntimeError("state is not set; call setup() first")
        metrics = self._init_epoch_metrics()

        # epoch-stepped LR (reference steps the torch scheduler per epoch)
        if self.scheduler is not None and self.scheduler.enabled:
            lr = self.scheduler.lr_for_epoch(epoch, self._last_val_loss)
            self._set_lr(lr)

        self._emit("before_train_epoch")

        # the loader's shuffle order (and any per-sample augmentation) is
        # keyed on the epoch: name it, so a resumed run sees the order of the
        # epoch it resumes at, not that of its first iteration
        if hasattr(data_loader, "set_epoch"):
            data_loader.set_epoch(epoch)
        n_batches = 0
        for batch in self._wrap_loader(data_loader):
            n_batches += 1
            self._emit("before_train_step")

            step_metrics = self.run_step(batch)
            self._update_metrics(metrics, step_metrics)

            self.logger.debug(f"Epoch {epoch} [Train] step {n_batches}: "
                              f"{self._format_progress_metrics(metrics)}")
            self.iter += 1

            self._emit("after_train_step")

        if n_batches == 0:
            self.logger.warning(
                f"Epoch {epoch} produced ZERO training batches — check "
                f"train_batch_size vs dataset size (drop_last discards any "
                f"partial batch); no parameters were updated this epoch."
            )

        # drain the step metrics the trainer deferred (the loss is read one
        # step late, so the host never waits on the step it just launched)
        self._update_metrics(metrics, self.flush_step_metrics())

        self._emit("after_train_epoch")

        out = self._finalize_epoch_metrics(metrics)
        if n_batches == 0:
            # an empty AverageMeter reports 0.0, which reads as perfect
            # convergence downstream — a zero-batch epoch must be visibly
            # broken in history/plots, not silently optimal
            out["loss"] = float("nan")
        return out

    @abstractmethod
    def run_step(self, batch) -> Dict[str, float]:
        ...

    def _wrap_loader(self, loader):
        """Optionally wrap the epoch's batch iterator (e.g. device prefetch)."""
        return loader

    def flush_step_metrics(self) -> Dict[str, float]:
        """Metrics a trainer deferred past the last run_step of the epoch."""
        return {}

    def _set_lr(self, lr: float) -> None:
        set_learning_rate(self.state.optimizer, lr)

    def current_lr(self) -> Optional[float]:
        optimizer = getattr(self.state, "optimizer", None)
        return None if optimizer is None else get_learning_rate(optimizer)

    # ------------------------------------------------------------------
    def _init_epoch_metrics(self) -> Dict[str, Any]:
        return {"loss": AverageMeter()}

    def _update_metrics(self, metrics, step_metrics):
        for key, value in step_metrics.items():
            if key in metrics:
                metrics[key].update(value)
            else:
                m = AverageMeter()
                m.update(value)
                metrics[key] = m

    def _format_progress_metrics(self, metrics) -> Dict[str, str]:
        out = {}
        for key, meter in metrics.items():
            if hasattr(meter, "avg"):
                out[key] = f"{meter.avg:.6f}" if key == "loss" else f"{meter.avg:.3f}"
        return out

    def _finalize_epoch_metrics(self, metrics) -> Dict[str, float]:
        final = {k: float(m.avg) for k, m in metrics.items() if hasattr(m, "avg")}
        lr = self.current_lr()
        if lr is not None:
            final["lr"] = lr
        return final

    # ------------------------------------------------------------------
    def eval_state(self):
        """What evaluation runs on. Base: the live training state;
        SegTrainer hands over the model, or a module carrying the EMA shadow
        when training.ema.eval is on — best-model selection (the
        CheckpointHook keys on evaluate()'s is_best) then follows the EMA
        metrics."""
        return self.state

    def _evaluate_with_strategy(self, data_loader) -> Dict[str, float]:
        return self.evaluation_strategy.evaluate_epoch(self.eval_state(), data_loader, device=self.device,
                                                       mesh=self.mesh)

    def evaluate(self, epoch: int, data_loader) -> Tuple[Dict[str, float], bool]:
        if self.evaluation_strategy is None:
            self.logger.warning("Evaluation skipped: no strategy attached to the trainer.")
            return {}, False
        self._emit("before_val")
        eval_stats = self._evaluate_with_strategy(data_loader)
        self.logger.info(f"Epoch {epoch} evaluation results: {eval_stats}")
        is_best = self._is_best_model(eval_stats)
        if is_best:
            self.best_metrics.update(eval_stats)
        self._emit("after_val", is_best)
        return eval_stats, is_best

    def eval_on_train(self, epoch: int, data_loader) -> Dict[str, float]:
        if self.evaluation_strategy is None:
            return {}
        stats = self._evaluate_with_strategy(data_loader)
        self.logger.info(f"Epoch {epoch} evaluation on train dataset results: {stats}")
        return stats

    def test(self, epoch: int, data_loader) -> Dict[str, float]:
        if self.evaluation_strategy is None:
            return {}
        stats = self._evaluate_with_strategy(data_loader)
        self.logger.info(f"Epoch {epoch} test results: {stats}")
        return stats

    def _is_best_model(self, eval_stats: Dict[str, float]) -> bool:
        return False
