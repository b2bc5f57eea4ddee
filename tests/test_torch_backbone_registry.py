"""Every registered 2D classifier of the port (``resnet18`` ... ``resnet152``,
``densenet121/169/201/161``, ``efficientnet_b0`` ... ``b7`` and ``v2_s/m/l``,
``vit_b_16`` ... ``vit_h_14``) against the flax model of the same name:
built on the ``meta`` device (no storage, so the 632M-parameter
``vit_h_14`` costs nothing), its parameters and running statistics carry
flax's paths (``models/convert.py:flax_path``) and shapes, and the Tent norm
mask picks exactly its BatchNorm and LayerNorm affines. The numbers of each
family are in tests/test_torch_backbones.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import multimodal_tta_tpu.models  # noqa: F401 (registration)
from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.registry import get_model as jax_get_model
from multimodal_tta_tpu_torch.models import layers as tl
from multimodal_tta_tpu_torch.models.convert import flax_path
from multimodal_tta_tpu_torch.registry import list_models
from multimodal_tta_tpu_torch.tta import norm_param_mask
from tests._torch_port import flat_flax, meta_model

CLASSIFIERS = sorted(n for n in list_models() if n.startswith(("resnet", "densenet", "efficientnet", "vit_")))


def test_the_reference_names_are_registered():
    assert len(CLASSIFIERS) == 25
    assert set(CLASSIFIERS) == {n for n in multimodal_tta_tpu.registry.list_models()
                                if n.startswith(("resnet", "densenet", "efficientnet", "vit_"))}


def _flax_shape_of(name: str, shape) -> tuple:
    """The flax leaf shape of a port tensor: OIHW -> HWIO, ``[out, in]`` ->
    ``[in, out]``; an attention projection as its product (the head split
    is flax's DenseGeneral layout, checked in tests/test_torch_transformers.py)."""
    shape = tuple(shape)
    if name.endswith(".weight") and len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    if name.endswith(".weight") and len(shape) == 2:
        return (shape[1], shape[0])
    return shape


@pytest.mark.parametrize("name", CLASSIFIERS)
def test_registered_names_match_the_flax_trees(name):
    """Every registered classifier, built on the ``meta`` device (no
    storage): its parameters and running statistics are flax's, by path
    (``flax_path``) and shape; the norm mask picks exactly the BatchNorm
    and LayerNorm affines."""
    side = 224 if name.startswith("vit") else 32
    jm = jax_get_model(name).from_config(JaxConfigNode({"name": name, "num_classes": 10}))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)), train=True))
    want = {k: tuple(a.shape) for coll in ("params", "batch_stats") for k, a in flat_flax(shapes.get(coll, {})).items()}
    tm = meta_model(name, {"name": name, "num_classes": 10})
    assert {t.device.type for t in tm.state_dict().values()} == {"meta"}
    got = {flax_path(k): _flax_shape_of(k, t.shape) for k, t in tm.state_dict().items()}
    attn = [k for k in want if "/MultiHeadDotProductAttention_0/" in k and k.endswith("kernel")]
    for k in attn:  # [H, heads, hd] / [heads, hd, H] against the port's 2-D product
        w = want.pop(k)
        g = got.pop(k)
        assert np.prod(w) == np.prod(g) and (w[0] == g[0] if not k.endswith("out/kernel") else w[-1] == g[-1]), k
    assert got == {k: (int(np.prod(v)),) if k.rpartition("/")[0].rpartition("/")[2] in ("query", "key", "value")
                   and k.endswith("bias") else v for k, v in want.items()}
    norms = {f"{mn}.{pn}" for mn, m in tm.named_modules() if isinstance(m, (tl.BatchNorm, tl.LayerNorm))
             for pn, _ in m.named_parameters(recurse=False)}
    assert norm_param_mask(tm) == {n: n in norms for n, _ in tm.named_parameters()}
    assert len(tl.running_statistics(tm)) == len(flat_flax(shapes.get("batch_stats", {})))


