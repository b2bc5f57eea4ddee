"""Hard pseudo-label test-time adaptation (method "pl"; the port of
``multimodal_tta_tpu/tta/pl.py``).

The PL baseline of the Tent paper: the norm affines adapt by cross-entropy
against the model's OWN hard predictions on the voxels whose confidence
clears ``tta.pl.conf_threshold`` (``ops/losses.py`` ``pseudo_label_loss``).
Everything else is the Tent adapter; only the objective differs. A batch
with no confident voxel gives zero gradient: the method abstains.
"""

from __future__ import annotations

from ..conf.node import ConfigNode
from ..registry import register_tta_method
from ..utils.config import get_config
from .tent import TentAdapter


@register_tta_method("pl")
class PseudoLabelAdapter(TentAdapter):
    """Tent adapter with the hard pseudo-label objective."""

    method = "pl"

    def __init__(self, tta_cfg, config=None, device_transform=None, *, device="cuda", mesh=None):
        tta_cfg = tta_cfg or ConfigNode()
        tta_cfg.setdefault("loss", "pl")
        loss = str(get_config(tta_cfg, "loss", "pl")).lower()
        if loss.split("+")[0] != "pl":
            raise ValueError(
                f"[pl] tta.loss={loss!r} is not a pseudo-label objective — "
                f"run it as tta.method=tent so results are not mislabeled"
            )
        super().__init__(tta_cfg, config=config, device_transform=device_transform, device=device, mesh=mesh)
