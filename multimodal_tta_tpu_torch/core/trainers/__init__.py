"""Concrete trainers of the port."""

from .seg_trainer import SegTrainer

__all__ = ["SegTrainer"]
