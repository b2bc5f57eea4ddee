"""Host-side batched data loader with threaded prefetch (the port's copy of
``multimodal_tta_tpu/data/loader.py``).

Replaces torch's DataLoader in the reference stack (reference:
src/datasets/base_builder.py:90-107). NIfTI decode (gzip inflate + header
parse) is IO/zlib bound and releases the GIL, so a thread pool saturates it
without worker processes; decoded batches are prefetched into a bounded queue
so the accelerator never waits on the host (SURVEY.md §7.3 hard-part 5).

Batches are dicts: numeric fields are stacked into numpy arrays, string
fields into lists — the same batch schema the reference's collate produces.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


def default_collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    if not samples:
        return {}
    out: Dict[str, Any] = {}
    for key in samples[0].keys():
        vals = [s[key] for s in samples]
        v0 = vals[0]
        if isinstance(v0, np.ndarray):
            out[key] = np.stack(vals, axis=0)
        elif isinstance(v0, (int, np.integer)):
            out[key] = np.asarray(vals, dtype=np.int64)
        elif isinstance(v0, (float, np.floating)):
            out[key] = np.asarray(vals, dtype=np.float32)
        else:
            out[key] = list(vals)
    return out


class HostLoader:
    """Iterable over batches of a map-style dataset.

    Each ``__iter__`` advances the epoch counter: shuffling order and any
    per-sample augmentation RNG keys derive from (seed, epoch, index), so runs
    are reproducible regardless of thread scheduling.
    """

    def __init__(
        self,
        dataset,
        *,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        collate_fn: Optional[Callable] = None,
        prefetch_batches: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.num_workers = max(0, int(num_workers))
        self.seed = int(seed)
        self.collate_fn = collate_fn or default_collate
        self.prefetch_batches = max(1, int(prefetch_batches))
        self._epoch = -1

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch) - 1  # next __iter__ lands on `epoch`

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.Generator(np.random.Philox(key=[self.seed, epoch]))
        return rng.permutation(n)

    def _batches(self, order: np.ndarray) -> List[np.ndarray]:
        n = len(order)
        nb = n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size
        return [order[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        self._epoch += 1
        epoch = self._epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        order = self._epoch_order(epoch)
        batches = self._batches(order)

        if self.num_workers == 0:
            for idxs in batches:
                yield self.collate_fn([self.dataset[int(i)] for i in idxs])
            return

        yield from self._threaded_iter(batches)

    def _threaded_iter(self, batches: List[np.ndarray]) -> Iterator[Dict[str, Any]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        SENTINEL = object()

        def put_or_abort(item) -> bool:
            """Bounded put that gives up when the consumer abandoned the
            epoch — otherwise a full queue would park this thread (and its
            worker pool) in q.put forever."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(lambda i: self.dataset[int(i)], idxs))
                        if not put_or_abort(self.collate_fn(samples)):
                            return
                put_or_abort(SENTINEL)
            except BaseException as e:  # propagate into consumer
                put_or_abort(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
