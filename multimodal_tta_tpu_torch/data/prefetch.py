"""Host->device prefetching (the port of ``multimodal_tta_tpu/data/prefetch.py``).

Keeps ``depth`` batches ahead of the consumer: for a CUDA device the array
fields are cast to their compact transfer dtypes on the host, staged in
pinned memory and copied with ``non_blocking=True``, so the copy of batch
k+1 is queued while the step for batch k is still running. Over ranks
(``mesh``) the global batch is zero-padded to a multiple of the data axis
and only this rank's rows cross to its device; ``_n_valid`` stays the
global count and ``_n_local`` counts this rank's valid rows. A batch that a
rank-aware loader already cut (``_rank_rows``, ``DeviceCachedLoader`` over
ranks) passes through as it is. Over a space axis a rank's rows also keep
only its depth slab (dim 1 of a volume).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Iterable, Iterator, Optional, Sequence

import torch

from .. import DeviceLike, resolve_device

# ``training.transfer_dtype`` -> the dtype images cross to the device in
# (None: as they come, f32)
TRANSFER_DTYPES = {"float32": None, "float16": torch.float16, "bfloat16": torch.bfloat16}


def prefetch_to_device(
    iterable: Iterable[Dict[str, Any]],
    device: DeviceLike = "cuda",
    *,
    depth: int = 2,
    array_keys: Sequence[str] = ("image", "label"),
    image_transfer_dtype: Optional[torch.dtype] = None,
    label_transfer_dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> Iterator[Dict[str, Any]]:
    """Yields batches with array fields (numpy arrays or tensors) already on
    ``device`` plus ``_n_valid`` = the true batch size.

    Transfer dtypes compress the H2D stream (e.g. float16 images + uint8
    labels quarter the bytes); consumers upcast on device. Labels here are
    binary/region masks or small integer id maps, both exact in uint8.
    """
    depth = max(1, int(depth))
    dev = resolve_device(device)
    dtypes = {"image": image_transfer_dtype, "label": label_transfer_dtype}
    mesh = mesh if mesh is not None and mesh.parallel else None

    def put(batch: Dict[str, Any]) -> Dict[str, Any]:
        if mesh is not None and batch.get("_rank_rows"):
            return batch
        present = [k for k in array_keys if k in batch]
        out = dict(batch)
        rows = None
        if mesh is not None and present:
            # zero rows pad the global batch to a multiple of the data axis
            n = len(batch[present[0]])
            pad_to = -(-n // mesh.data) * mesh.data
            rows = mesh.rows(pad_to)
        for k in present:
            t = torch.as_tensor(batch[k])
            if rows is not None:
                if t.shape[0] < pad_to:
                    t = torch.cat([t, t.new_zeros((pad_to - t.shape[0],) + tuple(t.shape[1:]))])
                t = mesh.local(t) if t.dim() >= 4 else t[rows]
            if dtypes.get(k) is not None:
                t = t.to(dtypes[k])
            if dev.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            out[k] = t.to(dev, non_blocking=True)
        n_valid = int(out[present[0]].shape[0]) if present else 0
        # an incoming batch may ALREADY carry _n_valid (a loader that pads
        # with duplicate rows): the true count is the minimum of the two
        if rows is not None:
            n_valid = n
        if "_n_valid" in batch:
            n_valid = min(n_valid, int(batch["_n_valid"]))
        out["_n_valid"] = n_valid
        if rows is not None:
            out["_n_local"] = max(0, min(rows.stop, n_valid) - rows.start)
            out["_rank_rows"] = True
        return out

    queue: deque = deque()
    it = iter(iterable)
    try:
        while True:
            while len(queue) < depth:
                queue.append(put(next(it)))
            yield queue.popleft()
    except StopIteration:
        while queue:
            yield queue.popleft()
