"""Evaluation strategies of the port; importing the package registers them."""

from .seg_eval import SegmentationEvaluationStrategy

__all__ = ["SegmentationEvaluationStrategy"]
