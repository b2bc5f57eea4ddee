"""Dataset builder base class (the port's copy of
``multimodal_tta_tpu/data/base_builder.py``).

Mirrors the reference's builder contract (reference:
src/datasets/base_builder.py:16-110): split normalization with aliases,
dataset/loader caching, and default loader arguments read from the training
config (batch_size vs eval_batch_size, shuffle/drop_last on train only,
deterministic seeding). The loader is this framework's threaded HostLoader
instead of a torch DataLoader.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Optional

from ..conf.node import ConfigNode
from ..utils.config import get_config
from ..utils.logger import get_logger
from .loader import HostLoader


class BaseDatasetBuilder(ABC):
    _ALLOWED = {"train", "val", "test"}
    _ALIASES = {
        "validate": "val",
        "validation": "val",
        "dev": "val",
        "train": "train",
        "test": "test",
        "val": "val",
    }
    _LOADER_ARG_KEYS = {
        "batch_size",
        "num_workers",
        "drop_last",
        "shuffle",
        "seed",
        "collate_fn",
        "prefetch_batches",
    }

    def __init__(self, config: ConfigNode):
        self.config = config
        self._datasets: Dict[str, Any] = {}
        self._loaders: Dict[str, HostLoader] = {}
        self.logger = get_logger()

        tcfg = get_config(config, "training", ConfigNode())
        self.batch_size: int = int(get_config(tcfg, "batch_size", 8))
        self.eval_batch_size: int = int(get_config(tcfg, "eval_batch_size", self.batch_size))
        self.num_workers: int = int(get_config(tcfg, "num_workers", 4))
        self.prefetch_batches: int = int(get_config(tcfg, "prefetch_batches", 2))
        self.seed: int = int(get_config(config, "task.seed", get_config(tcfg, "seed", 0)))

    def _normalize_split(self, split: str) -> str:
        s = self._ALIASES.get((split or "").strip().lower(), split)
        if s not in self._ALLOWED:
            raise ValueError(f"Unsupported split '{split}'. Allowed: {sorted(self._ALLOWED)}")
        return s

    def get_dataset(self, split: str, **overrides):
        if overrides:
            return self.build_dataset(split, **overrides)
        if split not in self._datasets:
            self._datasets[split] = self.build_dataset(split)
        return self._datasets[split]

    def get_loader(self, split: str, **overrides) -> Optional[HostLoader]:
        split = self._normalize_split(split)
        if overrides:
            dataset_overrides = {
                k: v for k, v in overrides.items() if k not in self._LOADER_ARG_KEYS and k != "dataset"
            }
            loader_overrides = {
                k: v for k, v in overrides.items() if k in self._LOADER_ARG_KEYS and v is not None
            }
            ds = overrides.get("dataset")
            if ds is None:
                ds = self.build_dataset(split, **dataset_overrides)
            if ds is None:
                return None
            args = self.default_loader_args(split)
            args.update(loader_overrides)
            return HostLoader(ds, **args)

        if split not in self._loaders:
            ds = self.get_dataset(split)
            if ds is None:
                return None
            self._loaders[split] = HostLoader(ds, **self.default_loader_args(split))
        return self._loaders[split]

    def default_loader_args(self, split: str) -> Dict[str, Any]:
        split = self._normalize_split(split)
        is_train = split == "train"
        return dict(
            batch_size=self.batch_size if is_train else self.eval_batch_size,
            shuffle=is_train,
            drop_last=is_train,
            num_workers=self.num_workers,
            seed=self.seed,
            prefetch_batches=self.prefetch_batches,
        )

    @abstractmethod
    def build_dataset(self, split: str, **overrides):
        ...
