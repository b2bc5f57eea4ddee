"""Experiment orchestration (the port of
``multimodal_tta_tpu/core/experiment_manager.py``).

``ExperimentManager(cfg, device="cuda")`` then ``setup_model / setup_data /
setup_optimizer / setup_scheduler / setup_trainer / train``, as in the
reference. The model is an ``nn.Module`` from the model registry on one
device; the optimizer is ``torch.optim`` with the reference's no-decay
param groups; seeding returns a ``torch.Generator``. There is no mesh and no
distributed launch yet (ROADMAP.md, parallel slice).

Data: ``setup_data`` goes through the dataset-builder registry (the
HECKTOR21 and BraTS builders of ``data/``), with ``training.device_cache``
staging the training set on the device (``data/device_cache.py``). A caller
may instead hand in loaders by setting ``train_loader`` / ``val_loader`` /
``test_loader``, and the train step's on-device transform by setting
``device_transform`` (a ``SegTransform.device_spec()``), before
``setup_trainer``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch

from .. import DeviceLike, resolve_device
from ..conf.node import ConfigNode
from ..registry import get_dataset_builder, get_evaluation_strategy, get_model, list_dataset_builders
from ..utils.config import get_config, require_config
from ..utils.logger import get_logger
from ..utils.metrics import set_random_seed
from .hooks import CheckpointHook, EarlyStoppingHook, MemoryMonitorHook, MetricsLoggerHook, TimerHook
from .optim import EpochScheduler, Optimizer, build_optimizer
from .train_state import TrainState, param_count
from .trainers.seg_trainer import SegTrainer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


class ExperimentManager:
    def __init__(self, config: ConfigNode, device: DeviceLike = "cuda"):
        if not isinstance(config, ConfigNode):
            raise TypeError("ExperimentManager expects a ConfigNode configuration")
        self.config = config
        self.logger = get_logger()
        self.device = resolve_device(device)

        seed = require_config(config, "task.seed")
        deterministic = str(get_config(config, "task.deterministic", "practical"))
        self.root_gen = set_random_seed(seed, deterministic)

        self.task_name = require_config(config, "task.name")
        self.eval_strategy_name = get_config(config, "task.eval_strategy")

        if bool(get_config(config, "training.debug_nans", False)):
            raise NotImplementedError(
                "training.debug_nans is not ported yet (ROADMAP.md, training slice left-overs)")

        self.model: Optional[torch.nn.Module] = None
        self.state: Optional[TrainState] = None
        self.optimizer: Optional[Optimizer] = None
        self.base_lr: Optional[float] = None
        self.scheduler: Optional[EpochScheduler] = None
        self.trainer: Optional[SegTrainer] = None

        self.train_loader = None
        self.val_loader = None
        self.test_loader = None
        self.device_transform: Optional[Dict[str, Any]] = None
        self._builder = None

        self.logger.info(f"ExperimentManager up — task '{self.task_name}' on {self.device}")
        self.logger.info(f"Random seed: {seed} | deterministic: {deterministic}")

    # ------------------------------------------------------------------
    def setup_model(self) -> torch.nn.Module:
        model_cfg = require_config(self.config, "model")
        model_name = require_config(model_cfg, "name", type_=str)
        model_cls = get_model(model_name)

        compute_dtype = str(get_config(self.config, "training.compute_dtype", "bfloat16"))
        if compute_dtype not in _DTYPES:
            raise ValueError(f"training.compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype}")
        remat = get_config(self.config, "training.remat", False)
        if bool(get_config(model_cfg, "pretrained", False)):
            raise NotImplementedError(
                "model.pretrained is not ported yet (ROADMAP.md, remaining models)")

        # the init seed is the root generator's first draw (the reference
        # splits its root key for the init)
        init_seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self.root_gen))
        self.model = model_cls.from_config(model_cfg, dtype=_DTYPES[compute_dtype], remat=remat,
                                           device=self.device, seed=init_seed)
        n_params = param_count(self.model)
        self.logger.info(
            f"Model created: {model_name} ({n_params / 1e6:.2f}M params, "
            f"compute_dtype={compute_dtype}, remat={remat})"
        )
        return self.model

    # ------------------------------------------------------------------
    def get_dataset_builder_for_task(self):
        try:
            builder_cls = get_dataset_builder(self.task_name)
        except KeyError:
            try:
                builder_cls = get_dataset_builder("default")
            except KeyError:
                raise KeyError(
                    f"no dataset builder is registered for task '{self.task_name}' (and no 'default' "
                    f"builder); registered: {list_dataset_builders()}") from None
        return builder_cls(self.config)

    def build_clean_dataset(self, split: str = "train"):
        return self.get_dataset_builder_for_task().get_dataset(split)

    def setup_train_data(self):
        builder = self.get_dataset_builder_for_task()

        train_ds = builder.get_dataset("train")
        val_ds = builder.get_dataset("val")
        test_ds = builder.get_dataset("test")

        if bool(get_config(self.config, "training.device_cache", False)):
            # decode once, stage the whole training set on the device, gather
            # batches there — removes per-step decode + H2D entirely
            from ..data.device_cache import DeviceCachedLoader

            args = builder.default_loader_args("train")
            self.train_loader = DeviceCachedLoader(
                train_ds,
                batch_size=args["batch_size"],
                shuffle=args["shuffle"],
                drop_last=args["drop_last"],
                seed=args["seed"],
                device=self.device,
                num_workers=args["num_workers"],
                shard_store=bool(get_config(self.config, "training.device_cache_sharded", False)),
                logger=self.logger,
            )
        else:
            self.train_loader = builder.get_loader("train", dataset=train_ds)
        if val_ds is None or len(val_ds) == 0:
            self.val_loader = None
            self.logger.warning("val dataset is empty; skip validation.")
        else:
            self.val_loader = builder.get_loader("val", dataset=val_ds)
        self.test_loader = builder.get_loader("test", dataset=test_ds) if test_ds is not None else None

        def n(dl):
            dataset = getattr(dl, "dataset", None)
            return len(dataset) if dataset is not None else "?"

        self.logger.info(
            f"Loaders ready for '{self.task_name}': "
            f"train={n(self.train_loader)} val={n(self.val_loader) if self.val_loader else 0} "
            f"test={n(self.test_loader) if self.test_loader else 0}"
        )
        self._builder = builder
        return self.train_loader, self.val_loader, self.test_loader

    def setup_test_data(self):
        builder = self.get_dataset_builder_for_task()
        self.test_loader = builder.get_loader("test")
        self._builder = builder
        return self.test_loader

    def setup_data(self, mode: str = "train"):
        mode = str(mode).lower()
        if mode == "train":
            return self.setup_train_data()
        if mode == "test":
            return self.setup_test_data(), None
        raise ValueError(f"Unknown mode: {mode}. Expected 'train' or 'test'.")

    # ------------------------------------------------------------------
    def setup_optimizer(self) -> Optimizer:
        if self.model is None:
            raise ValueError("Model must be setup before optimizer")
        training_cfg = require_config(self.config, "training")
        self.optimizer, self.base_lr = build_optimizer(training_cfg, self.model)
        self.state = TrainState(model=self.model, optimizer=self.optimizer)
        opt_name = get_config(training_cfg, "optimizer", "sgd")
        self.logger.info(f"Optimizer created (primary): {opt_name} lr={self.base_lr}")
        return self.optimizer

    def setup_scheduler(self) -> EpochScheduler:
        if self.optimizer is None:
            raise ValueError("Optimizer must be setup before scheduler")
        training_cfg = require_config(self.config, "training")
        self.scheduler = EpochScheduler(training_cfg, self.base_lr)
        if self.scheduler.enabled:
            self.logger.info(f"Scheduler created: {self.scheduler.name}")
        return self.scheduler

    # ------------------------------------------------------------------
    def setup_hooks(self, run_dir: Optional[str] = None):
        hooks = [TimerHook()]

        run_dir = run_dir or get_config(self.config, "task.save_dir", "./outputs")
        ckpt_dir = os.path.join(run_dir, "checkpoints")
        model_save_freq = int(get_config(self.config, "training.model_save_freq", 1))
        model_save_start = int(get_config(self.config, "training.model_save_start", 50))
        ckpt_format = str(get_config(self.config, "training.checkpoint_format", "torch"))
        self.checkpoint_hook = CheckpointHook(ckpt_dir, model_save_freq, model_save_start, fmt=ckpt_format)
        hooks.append(self.checkpoint_hook)

        hooks.append(MemoryMonitorHook())
        hooks.append(MetricsLoggerHook())

        if bool(get_config(self.config, "training.profile.enabled", False)):
            raise NotImplementedError(
                "training.profile (ProfilerHook) is not ported yet (ROADMAP.md, training slice left-overs)")

        es = get_config(self.config, "training.early_stopping", None)
        if es is not None and bool(get_config(es, "enabled", False)):
            hooks.append(
                EarlyStoppingHook(
                    metric=str(get_config(es, "metric", "loss")),
                    mode=str(get_config(es, "mode", "min")),
                    patience=int(get_config(es, "patience", 10)),
                    min_delta=float(get_config(es, "min_delta", 0.0)),
                )
            )

        self.trainer.register_hooks(hooks)
        self.logger.info(f"Hook set attached ({len(hooks)} hooks)")

    def setup_trainer(self, run_dir: Optional[str] = None):
        if self.state is None:
            raise ValueError("Model and optimizer must be setup before the trainer")
        if self.eval_strategy_name is None:
            evaluation_strategy = None
        else:
            evaluation_cls = get_evaluation_strategy(self.eval_strategy_name)
            evaluation_strategy = evaluation_cls(self.config)

        task_lower = str(self.task_name).lower()
        is_seg = "seg" in task_lower or "brats" in task_lower or "hecktor21" in task_lower
        if not is_seg:
            raise ValueError(f"Unknown trainer type: {self.task_name}")

        device_transform = self.device_transform
        if self._builder is not None and hasattr(self._builder, "build_transform"):
            device_transform = self._builder.build_transform("train").device_spec()

        self.trainer = SegTrainer(
            self.config,
            evaluation_strategy=evaluation_strategy,
            device_transform=device_transform,
            device=self.device,
        )
        self.trainer.setup(self.state, evaluation_strategy, self.scheduler)
        self.setup_hooks(run_dir)

        resume = get_config(self.config, "training.resume", None)
        if resume:
            self.trainer.start_epoch = self.checkpoint_hook.load(str(resume))
            self.state = self.trainer.state

        self.logger.info(f"{type(self.trainer).__name__} ready for '{self.task_name}'")

    # ------------------------------------------------------------------
    def train(self, epochs: int) -> Dict[str, List]:
        if self.trainer is None:
            raise ValueError("Trainer must be setup before training")
        self.logger.info(f"Launching {epochs}-epoch training run")
        eval_on_train = bool(get_config(self.config, "training.eval_on_train", False))
        results = self.trainer.train(
            epochs=int(epochs),
            train_loader=self.train_loader,
            val_loader=self.val_loader,
            test_loader=self.test_loader,
            eval_on_train=eval_on_train,
        )
        # the trainer's state is the live one (a resume replaced it)
        self.state = self.trainer.state
        self.logger.info("Training completed")
        return results
