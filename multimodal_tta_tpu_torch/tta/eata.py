"""EATA: efficient anti-forgetting test-time adaptation (method "eata"; the
port of ``multimodal_tta_tpu/tta/eata.py``).

Niu et al., "Efficient Test-Time Model Adaptation without Forgetting" (ICML
2022 — public method). Both halves are knobs of the Tent adapter, and this
method turns them on together:

  1. sample-adaptive gating (``tta.reliability``, ``tent.reliability_weights``);
  2. Fisher anti-forgetting (``tta.fisher``): a diagonal-Fisher anchor toward
     the source model, estimated on the first served batches and applied as
     a proximal step after each update.

The subclass fills those defaults and refuses a config with both off, which
would be plain Tent under an "eata" label.
"""

from __future__ import annotations

from ..conf.node import ConfigNode
from ..registry import register_tta_method
from ..utils.config import get_config
from .tent import TentAdapter


@register_tta_method("eata")
class EataAdapter(TentAdapter):
    """Tent adapter with both EATA mechanisms on by default."""

    method = "eata"

    def __init__(self, tta_cfg, config=None, device_transform=None, *, device="cuda", mesh=None):
        tta_cfg = tta_cfg or ConfigNode()
        rel = tta_cfg.setdefault("reliability", ConfigNode())
        rel.setdefault("enabled", True)
        fsh = tta_cfg.setdefault("fisher", ConfigNode())
        fsh.setdefault("enabled", True)
        if not (bool(get_config(rel, "enabled")) or bool(get_config(fsh, "enabled"))):
            raise ValueError(
                "[eata] both reliability and fisher are disabled — that is "
                "plain Tent; run it as tta.method=tent so results are not "
                "mislabeled"
            )
        super().__init__(tta_cfg, config=config, device_transform=device_transform, device=device, mesh=mesh)
