"""Running-average meters and seeding (the port of
``multimodal_tta_tpu/utils/metrics.py``).

``AverageMeter`` is the reference utility unchanged. ``set_random_seed``
keeps the three determinism presets and maps them onto PyTorch: it seeds
``random``, numpy and torch, and returns a seeded ``torch.Generator`` where
the reference returns a root PRNG key.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


class AverageMeter:
    """Tracks a running sum/count/average of a scalar series."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += int(n)
        self.avg = self.sum / max(1, self.count)


def set_random_seed(seed: int, deterministic: str = "practical") -> torch.Generator:
    """Seed the host RNGs and torch; return a CPU ``torch.Generator`` seeded
    with ``seed``.

    Modes:
      - "off":        seed only.
      - "practical":  + cuDNN picks its algorithms by heuristics, not by
                      timing (``cudnn.benchmark = False``), so a shape gets
                      the same algorithm in every run.
      - "strict":     + ``torch.use_deterministic_algorithms(True)`` and
                      ``cudnn.deterministic = True``: every op takes a
                      deterministic implementation or raises (may be slower).

    The flags are process-wide; a mode other than "strict" switches the two
    strict flags off again. "strict" also sets ``CUBLAS_WORKSPACE_CONFIG``
    where it is unset, which cuBLAS reads only at its first call in the
    process: after that the variable only quiets PyTorch's check, and the
    workspace stays as it was. A caller that wants cuBLAS deterministic sets
    the variable before any cuBLAS work (``chip_smoke.py`` does so at start).
    """
    seed = int(seed)
    mode = str(deterministic).lower()
    if mode not in ("off", "practical", "strict"):
        raise ValueError(f"Unknown deterministic mode: {deterministic}")
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    if mode in ("practical", "strict"):
        torch.backends.cudnn.benchmark = False
    strict = mode == "strict"
    if strict:
        # cuBLAS needs a fixed workspace to be deterministic (read at its first call)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = strict
    torch.use_deterministic_algorithms(strict)

    return torch.Generator().manual_seed(seed)
