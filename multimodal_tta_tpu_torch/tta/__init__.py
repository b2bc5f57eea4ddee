"""Test-time adaptation methods of the port; importing the package
registers them."""

from .tent import TentAdapter, norm_param_mask

__all__ = ["TentAdapter", "norm_param_mask"]
