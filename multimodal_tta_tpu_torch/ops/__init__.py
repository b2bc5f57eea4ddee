"""Tensor ops of the port: augmentation, intensity normalisation, losses,
segmentation and surface metrics, sliding-window inference, SSIM and the
resampler of the offline preprocessing.

The names below load on first use (a module ``__getattr__``), so importing
one op module, as the serving runtime imports ``ops.augment``, loads no
other."""

import importlib

_EXPORTS = {
    "augment": ("modality_dropout", "rand_intensity_scale_shift", "rand_rot90"),
    "intensity": ("make_intensity_normalizer", "zscore_masked"),
    "losses": ("dice_ce_loss", "entropy_loss", "focal_loss", "make_criterion", "make_dice_ce_loss",
               "soft_dice_loss", "triplet_margin_loss"),
    "seg_metrics": ("binary_dice_iou", "dice_iou_from_logits"),
    "sliding_window": ("sliding_window_inference",),
    "ssim": ("MS_SSIM", "SSIM", "ms_ssim", "ssim"),
    "surface": ("batched_surface_metrics", "squared_edt", "surface_metrics_single"),
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}

__all__ = list(_MODULE_OF)


def __getattr__(name):
    module = _MODULE_OF.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{module}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
