"""PyTorch/CUDA port of ``multimodal_tta_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here keeps
the name of its JAX counterpart, and ``tests/test_torch_*.py`` run both on
the same weights and inputs. Public functions keep the reference's
channels-last NDHWC layout.

Entry points take an explicit ``device``. It defaults to ``"cuda"`` and a
missing GPU raises; the CPU is used only when the caller asks for it
(``device="cpu"``), as the CPU tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (the default) and absent — the
    port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "multimodal_tta_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


__all__ = ["resolve_device", "DeviceLike"]
