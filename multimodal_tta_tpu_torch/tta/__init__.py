"""Test-time adaptation methods of the port; importing the package
registers them."""

from .engine import TTAEngine
from .tent import TentAdapter, norm_param_mask

__all__ = ["TTAEngine", "TentAdapter", "norm_param_mask"]
