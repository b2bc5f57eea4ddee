"""Carry flax UNet3D weights across to the port's ``UNet3D``.

``unet3d_from_flax(params)`` takes the flax ``params`` tree as a nested dict
of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and returns
a ``state_dict`` for ``UNet3D.load_state_dict``. It imports no JAX.

  * conv ``kernel`` ``[kd, kh, kw, in, out]`` -> ``weight`` ``[out, in, kd, kh, kw]``
  * transposed conv (the ``up`` module of ``TransposedConvUp``): flax's
    ``nn.ConvTranspose`` with ``transpose_kernel=False`` correlates the
    dilated input with the kernel as stored, while ``conv_transpose3d``
    scatters it, so the kernel is flipped spatially and laid out as
    ``[in, out, kd, kh, kw]``
  * ``bias`` as is; norm ``scale``/``bias`` by name
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_TRANSPOSED = "up"  # module name of TransposedConvUp's nn.ConvTranspose


def _leaves(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def unet3d_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        a = np.asarray(leaf, dtype=np.float32)
        mod, name = path[:-1], path[-1]
        if name == "kernel":
            if a.ndim != 5:
                raise ValueError(f"{'/'.join(path)}: expected a 3D conv kernel, got {a.shape}")
            if mod[-1] == _TRANSPOSED:
                a = a[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
            else:
                a = a.transpose(4, 3, 0, 1, 2)
            name = "weight"
        sd[".".join(mod + (name,))] = torch.from_numpy(a.copy())  # C-contiguous, writable
    return sd
