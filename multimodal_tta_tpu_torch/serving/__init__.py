"""Serving artifacts (the port of ``multimodal_tta_tpu/serving/``): the
fused adapt+segment step (or a plain forward) as one file that a runtime
replays with no model code, no config composer and no checkpoint loader —
see ``serving/export.py``."""

from .export import (
    ServingArtifact,
    export_adapt_serving,
    export_forward_serving,
    load_artifact,
    save_artifact,
)

__all__ = [
    "ServingArtifact",
    "export_adapt_serving",
    "export_forward_serving",
    "load_artifact",
    "save_artifact",
]
