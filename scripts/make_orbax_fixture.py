#!/usr/bin/env python3
"""Write the reference orbax checkpoint that the port's tests and
``chip_smoke.py`` read: ``tests/data/orbax_reference/``.

    JAX_PLATFORMS=cpu python scripts/make_orbax_fixture.py

It uses the JAX package on the CPU with 8 forced host devices: the flagship
UNet3D at the parity tests' width (``tests/_torch_port.py:SMALL``) takes two
Adam steps through the JAX ``SegTrainer`` with EMA on, and the state, with
one leaf sharded over a ``data`` axis of 8 devices in ``batch_stats``
(``acc``, 8 chunks, as ``tests/test_checkpoint.py`` builds one), is saved
with the JAX package's ``save_checkpoint_sharded`` as ``ckpt.orbax`` and
``ckpt.json``. ``expected.npz`` holds every leaf by its orbax param name
(the key path joined by ``.``; ``bfloat16`` as its ``uint16`` bits). The
frames are tensorstore's level-1 zstd: Huffman literals and FSE-coded
sequences among them.
"""

from __future__ import annotations

import os
import shutil
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

OUT = os.path.join(REPO, "tests", "data", "orbax_reference")
TRAINING = {"optimizer": "adam", "optimizers": {"adam": {"lr": 1e-3, "weight_decay": 5e-4}},
            "ema": {"enabled": True, "decay": 0.9}}


def main() -> None:
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from multimodal_tta_tpu.core.checkpoint import save_checkpoint_sharded
    from multimodal_tta_tpu.models.unet3d import UNet3D as JaxUNet3D
    from multimodal_tta_tpu_torch.models import UNet3D
    from tests._torch_port import SMALL, SMALL_SHAPE, random_flax_params, trainer_config, trainer_pair
    from tests.test_torch_seg_trainer import make_volumes

    jm = JaxUNet3D(**SMALL)
    params = random_flax_params(jm, (1,) + SMALL_SHAPE, seed=3)
    jt, _ = trainer_pair(trainer_config(TRAINING), jm, UNet3D(**SMALL, device="cpu"), params)
    img, lbl = make_volumes(4, seed=7)
    for i in (0, 2):
        jt.run_step({"image": img[i:i + 2], "label": lbl[i:i + 2]})
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    acc = jnp.arange(8 * 2048, dtype=jnp.float32).reshape(8, 2048) * 0.25
    state = jt.state.replace(batch_stats={"acc": jax.device_put(acc, NamedSharding(mesh, P("data")))})
    if os.path.exists(OUT):
        shutil.rmtree(OUT)
    os.makedirs(OUT)
    save_checkpoint_sharded(os.path.join(OUT, "ckpt"), state, {"epoch": 1, "best_metrics": {"dice": 0.5}})
    payload = {"step": state.step, "params": state.params, "batch_stats": state.batch_stats,
               "opt_state": state.opt_state, "ema_params": state.ema_params}
    leaves = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(payload))[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in path)
        a = np.asarray(leaf)
        leaves[name] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    np.savez(os.path.join(OUT, "expected.npz"), **leaves)
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(OUT) for f in fs)
    print(f"{OUT}: {len(leaves)} leaves, {total} bytes")


if __name__ == "__main__":
    main()
