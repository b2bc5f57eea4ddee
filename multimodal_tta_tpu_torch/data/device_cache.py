"""Device-resident training dataset cache (the port of
``multimodal_tta_tpu/data/device_cache.py``).

Decode the training set ONCE, stage it on the GPU (compact dtypes: f16
images + uint8 masks, one device tensor each), and assemble every batch with
an on-device ``index_select`` from a host-chosen permutation. Per-step NIfTI
decode and host->device transfer disappear from the training loop: what
crosses per step is one index vector. HECKTOR21-sized sets are about 1.2 GB
in f16 against the H100's 80 GB.

Batch order is the :class:`~.loader.HostLoader`'s for the same ``(seed,
shuffle, drop_last)``: both draw the epoch permutation from
``np.random.Philox(key=[seed, epoch])``. The values are the host loader's
after its f16 image / uint8 label transfer, bitwise.

Host-side RANDOM transforms cannot be baked into a decode-once cache (they
must re-randomize per epoch); datasets carrying one are rejected at
construction. Deterministic host transforms are applied during the one-time
decode; on-device normalization/augmentation stays in the train step.

Over ranks (``mesh``) there are the reference's two stores:

  * replicated (the default): every rank holds the whole set; batch k is
    the one-process batch's index vector padded (with sample 0, masked by
    ``_n_valid``) to a multiple of the data axis, and each rank gathers its
    rows;
  * sharded (``training.device_cache_sharded``, ``shard_store``): rank ``r``
    stores only its block of ``ceil(n/w)`` samples, the tail wrapped by
    ``i % n``, and draws its own Philox permutation of that block with key
    ``[seed + 0x9E3779B9*(r+1), epoch]``; batch k is every rank's k-th slice
    of ``batch_size / w`` (a distributed sampler), sample for sample the
    reference's order. It needs ``batch_size`` divisible by the data axis
    and ``drop_last``, and is the replicated store on one rank.

Batches over ranks hold this rank's rows (``_rank_rows``) and the global
``_n_valid``.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..utils.logger import get_logger

# the host loader's transfer dtypes (data/prefetch.py TRANSFER_DTYPES): the
# store holds exactly what a host-loaded batch carries to the device
_IMAGE_DTYPE = np.float16
_LABEL_DTYPE = np.uint8


def _rejects_host_random_transform(dataset) -> None:
    t = getattr(dataset, "transform", None)
    if t is None:
        return
    geom = bool(getattr(t, "geom_aug", False))
    host_int = bool(getattr(t, "intensity_aug", False)) and not bool(
        getattr(t, "on_device", False)
    )
    if geom or host_int:
        which = "geometric" if geom else "intensity"
        raise ValueError(
            f"[device_cache] dataset transform performs host-side {which} "
            f"augmentation, which cannot be baked into a decode-once device "
            f"cache (it must re-randomize every epoch). Use on-device "
            f"augmentation (transform on_device=True) or the host loader."
        )


class DeviceCachedLoader:
    """Iterable over device-resident batches of a map-style dataset.

    Drop-in for :class:`HostLoader` on the training path: each ``__iter__``
    advances the epoch and yields ``{"image", "label", "_n_valid"}`` batches
    whose array fields are already tensors on ``device``.
    ``store_bytes`` and ``stage_seconds`` (decode + copy to the device)
    describe the one-time staging.
    """

    device_resident = True

    def __init__(
        self,
        dataset,
        *,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        device: DeviceLike = "cuda",
        num_workers: int = 8,
        shard_store: bool = False,
        mesh=None,
        logger=None,
    ):
        _rejects_host_random_transform(dataset)
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.logger = logger or get_logger()
        self.mesh = mesh if mesh is not None and mesh.parallel else None
        self._epoch = -1

        n = len(dataset)
        if n == 0:
            raise ValueError("[device_cache] dataset is empty")
        if self.drop_last and n < self.batch_size:
            raise ValueError(
                f"[device_cache] batch_size ({self.batch_size}) exceeds the "
                f"dataset ({n} cases) with drop_last=True — every epoch would "
                f"silently train zero steps"
            )

        self.shard_store = bool(shard_store) and self.mesh is not None
        if self.shard_store:
            shards = self.mesh.data
            if self.batch_size % shards:
                raise ValueError(
                    f"[device_cache] shard_store needs batch_size ({self.batch_size}) "
                    f"divisible by the data axis ({shards})"
                )
            if not self.drop_last:
                raise ValueError(
                    "[device_cache] shard_store requires drop_last=True (a ragged "
                    "tail would interleave padding inside shard segments, breaking "
                    "the leading-rows-valid contract of _n_valid)"
                )
        elif shard_store:
            self.logger.info("[device_cache] one rank: the sharded store is the replicated one")

        # ---- one-time decode (threaded: NIfTI inflate releases the GIL) ----
        t0 = time.perf_counter()
        if hasattr(dataset, "set_epoch"):
            dataset.set_epoch(0)  # transforms here are deterministic (checked)
        workers = max(1, int(num_workers))
        # decode sample 0 to learn shapes, then preallocate the compact-dtype
        # stores and have workers write rows IN PLACE — peak host RAM stays at
        # the store size
        s0 = dataset[0]
        img0 = np.asarray(s0["image"])
        lbl0 = np.asarray(s0["label"])
        images = np.empty((n,) + img0.shape, _IMAGE_DTYPE)
        labels = np.empty((n,) + lbl0.shape, _LABEL_DTYPE)
        images[0] = img0
        labels[0] = lbl0
        del s0, img0, lbl0

        def decode_into(i: int) -> None:
            s = dataset[int(i)]
            images[i] = np.asarray(s["image"])
            labels[i] = np.asarray(s["label"])

        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(decode_into, range(1, n)))

        # ---- stage on the device: one tensor per field ----
        if self.shard_store:
            # this rank's block of the samples, the tail wrapped (row i is
            # sample i % n: real training data, merely re-sampled)
            self._per_shard = -(-n // self.mesh.data)
            d = self.mesh.data_rank
            block = np.arange(d * self._per_shard, (d + 1) * self._per_shard) % n
            images, labels = images[block], labels[block]
        if self.mesh is not None and self.mesh.space > 1:
            # over a space axis this rank stages only its depth slab
            slab = self.mesh.slab(images.shape[1])
            images, labels = np.ascontiguousarray(images[:, slab]), np.ascontiguousarray(labels[:, slab])
        self._images = torch.from_numpy(images).to(self.device)
        self._labels = torch.from_numpy(labels).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stage_seconds = time.perf_counter() - t0
        self.store_bytes = images.nbytes + labels.nbytes
        self.logger.info(
            f"[device_cache] staged {n} cases on {self.device} in {self.stage_seconds:.2f} s: "
            f"image {tuple(images.shape)} {images.dtype}, label {tuple(labels.shape)} "
            f"{labels.dtype} ({self.store_bytes / 2**30:.3f} GiB total)"
        )

        # the one-time decode routed through the dataset's own in-memory
        # decode cache (when dataset.cache_in_memory is also set) — those
        # host-side float32 copies are dead weight now that every batch
        # comes from the device, so release them (the disk cache has no RAM
        # cost and is left alone)
        ds_cache = getattr(dataset, "_cache", None)
        if ds_cache is not None and hasattr(ds_cache, "clear"):
            ds_cache.clear()

    # -- HostLoader-compatible surface --------------------------------------
    def __len__(self) -> int:
        if self.shard_store:
            return self._per_shard // (self.batch_size // self.mesh.data)
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

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        self._epoch += 1
        if self.shard_store:
            yield from self._iter_sharded(self._epoch)
            return
        order = self._epoch_order(self._epoch)
        n = len(order)
        bs = self.batch_size
        nb = n // bs if self.drop_last else (n + bs - 1) // bs
        for b in range(nb):
            idxs = order[b * bs: (b + 1) * bs]
            n_valid = len(idxs)
            if self.mesh is not None:
                # pad the index vector (not the volumes) to the data axis
                pad_to = -(-n_valid // self.mesh.data) * self.mesh.data
                idxs = np.concatenate([idxs, np.zeros(pad_to - n_valid, idxs.dtype)])[self.mesh.rows(pad_to)]
            yield self._gather(idxs, n_valid)

    def _gather(self, idxs: np.ndarray, n_valid: int) -> Dict[str, Any]:
        idx = torch.from_numpy(idxs.astype(np.int64)).to(self.device, non_blocking=True)
        batch = {"image": self._images.index_select(0, idx), "label": self._labels.index_select(0, idx),
                 "_n_valid": n_valid}
        if self.mesh is not None:
            batch["_rank_rows"] = True
        return batch

    def _iter_sharded(self, epoch: int) -> Iterator[Dict[str, Any]]:
        """Distributed-sampler epoch: this rank's Philox permutation of its
        block, ``batch_size / w`` rows a batch (the reference's order)."""
        bsl = self.batch_size // self.mesh.data
        m = self._per_shard
        perm = np.arange(m)
        if self.shuffle:
            # Philox takes a 2-word key; the rank folds into the first word
            key = [self.seed + 0x9E3779B9 * (self.mesh.data_rank + 1), epoch]
            perm = np.random.Generator(np.random.Philox(key=key)).permutation(m)
        for b in range(m // bsl):
            yield self._gather(perm[b * bsl:(b + 1) * bsl], self.batch_size)
