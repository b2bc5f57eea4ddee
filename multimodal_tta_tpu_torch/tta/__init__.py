"""Test-time adaptation methods of the port; importing the package
registers them: ``tent``, ``pl``, ``eata``, ``norm``, ``sar``, ``cotta`` and
``memo``."""

from .cotta import CottaAdapter
from .eata import EataAdapter
from .engine import TTAEngine, classifier_logits_apply
from .memo import MemoAdapter
from .norm_adapt import NormAdapter
from .pl import PseudoLabelAdapter
from .sar import SarAdapter
from .stream import StreamTTAController, evaluate_stream
from .tent import TentAdapter, norm_param_mask

__all__ = [
    "TTAEngine",
    "TentAdapter",
    "PseudoLabelAdapter",
    "EataAdapter",
    "NormAdapter",
    "SarAdapter",
    "CottaAdapter",
    "MemoAdapter",
    "StreamTTAController",
    "evaluate_stream",
    "norm_param_mask",
    "classifier_logits_apply",
]
