"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``): build a flax module's params from
a seed, carry them to the port, and move arrays across as numpy."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodal_tta_tpu_torch.models.convert import unet3d_from_flax

# HECKTOR21 on-device transform (mirror of bench.py's DEVICE_TRANSFORM)
HECKTOR_POLICY = {
    "enabled": True,
    "channel_names": ["ct", "pt"],
    "channels": {
        "ct": {"clip": [-1000, 1000], "zscore": {"masked": True, "mask_gt": -900, "eps": 1e-6}},
        "pt": {"clip": [0.0, 15.0], "zscore": {"masked": True, "mask_gt": 0.0, "eps": 1e-6}},
    },
}
DEVICE_TRANSFORM = {"normalize": True, "intensity_policy": HECKTOR_POLICY, "channel_names": ["ct", "pt"]}

# the dryrun UNet3D of the parity tests
DRYRUN = dict(in_channels=2, num_classes=1, channels=(4, 8, 16, 32, 64),
              strides=(2, 2, 2, 2), num_res_units=2)


def np_params(module, x, seed: int = 0, **call_kw):
    """Init a flax module on ``x`` and return its params as nested numpy."""
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), **call_kw)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def randomize(params, seed: int):
    """Replace every leaf with N(0, 0.3^2) noise, so biases and norm affines
    are not their trivial init values."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.3).astype(np.float32), params)


def load_flax(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(unet3d_from_flax(params), strict=True)
    return module


def to_ncdhw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 4, 1, 2, 3)


def to_ndhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 4, 1).float().numpy()


# the small UNet3D of the training parity tests: two levels, f32, on
# [B, 8, 16, 16, 2] volumes
SMALL = dict(in_channels=2, num_classes=1, channels=(4, 8, 16), strides=(2, 2), num_res_units=2)
SMALL_SHAPE = (8, 16, 16, 2)


def random_flax_params(module, x_shape, seed: int = 0):
    """Params of a flax module built from its shapes alone (``jax.eval_shape``
    of ``init``, nothing compiled), filled from a numpy seed: lecun-scaled
    kernels, norm scales near 1, small nonzero biases."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(x_shape), train=True))["params"]
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(leaf.shape)
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = 0.1 * rng.randn(*shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flat_flax(tree) -> dict:
    """A flax params-like tree as ``{'/'-joined path: leaf}``."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf for path, leaf in leaves}
