"""The port's config copies (ConfigNode, get_config) read a config the way
the JAX package's do."""

import pytest
import torch

from multimodal_tta_tpu.conf import ConfigNode as JaxConfigNode
from multimodal_tta_tpu.utils.config import get_config as jax_get_config
from multimodal_tta_tpu_torch.conf import ConfigNode
from multimodal_tta_tpu_torch.utils.config import get_config

torch.set_num_threads(1)

DATA = {"tta": {"steps": 2, "lr": 1, "episodic": "yes", "window": {"roi_size": [32, 96, 96]},
                "update_path_regex": None},
        "training": {"criterion": {"sigmoid": True}}}


@pytest.mark.parametrize("path,default,type_", [
    ("tta.steps", 1, None), ("tta.lr", 0.5, float), ("tta.episodic", False, bool),
    ("tta.window.roi_size", None, None), ("tta.window.roi_size.1", None, None),
    ("tta.update_path_regex", "dflt", None), ("tta.missing.deep", 7, None),
    ("training.criterion.sigmoid", False, None), ("tta.steps", "x", str),
])
def test_get_config_matches_reference(path, default, type_):
    want = jax_get_config(JaxConfigNode(DATA), path, default, type_)
    assert get_config(ConfigNode(DATA), path, default, type_) == want
    assert get_config(DATA, path, default, type_) == jax_get_config(DATA, path, default, type_)


def test_config_node_access():
    cfg = ConfigNode(DATA)
    assert cfg.tta.steps == 2 and cfg["tta"]["window"].roi_size == [32, 96, 96]
    assert "tta" in cfg and len(cfg) == 2 and bool(ConfigNode()) is False
    assert cfg.to_container() == JaxConfigNode(DATA).to_container()
    with pytest.raises(AttributeError):
        cfg.nope
