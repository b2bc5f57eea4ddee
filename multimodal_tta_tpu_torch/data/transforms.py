"""3D segmentation transforms (the port's copy of
``multimodal_tta_tpu/data/transforms.py``).

Host-side (numpy) transform pipeline with the exact semantics of the
reference's closure-based pipeline (reference: src/datasets/transforms.py:45-341):

  - strict spatial-shape assertion against ``image_size`` — this framework,
    like the reference, NEVER resizes online; offline preprocessing owns shape
  - label-kind inference raw vs region, dtype restoration (raw -> int64
    ``[D,H,W]``, region -> float32 ``[D,H,W,R]``)
  - train-only geometric aug: random rot90 on the (H, W) axes, prob 0.3, k≤3
  - normalization: per-channel intensity policy (clip + masked z-score) or
    legacy mean/std
  - train-only intensity aug (scale/shift ±0.1, prob 0.5) applied AFTER
    normalization

Arrays are channels-LAST (image ``[D,H,W,C]``, region label ``[D,H,W,R]``),
and with ``on_device`` normalization + intensity aug are deferred to the
device (the train step runs them through
``ops.intensity.make_intensity_normalizer`` / ``ops.augment`` as
``device_spec()`` asks). With ``on_device=False`` the full reference
pipeline runs on the host.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np


def _to_plain_dict(x: Any) -> Dict[str, Any]:
    if x is None:
        return {}
    if hasattr(x, "to_container"):
        return x.to_container()
    if isinstance(x, dict):
        return x
    try:
        return dict(x)
    except Exception:
        return {}


def normalize_host(
    img: np.ndarray,
    *,
    intensity_policy: Optional[Dict[str, Any]] = None,
    channel_names: Optional[Sequence[str]] = None,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Numpy mirror of ops.intensity.make_intensity_normalizer.

    img: [D,H,W,C] float32.
    """
    if img.ndim != 4:
        raise ValueError(f"[transforms] expect image [D,H,W,C], got {img.shape}")
    c = img.shape[-1]

    ip = _to_plain_dict(intensity_policy)
    if bool(ip.get("enabled", False)):
        names = list(channel_names) if channel_names is not None else ip.get("channel_names")
        if names is None:
            names = [str(i) for i in range(c)]
        if len(names) != c:
            raise RuntimeError(
                f"[transforms] len(channel_names)={len(names)} != C={c}; align "
                f"dataset.modality_order / transforms.channel_names with channels"
            )
        channels_cfg = ip.get("channels", {}) or {}
        out = img.copy()
        for ci, name in enumerate(names):
            rule = channels_cfg.get(str(name), {}) or {}
            x = out[..., ci]
            clip = rule.get("clip")
            if isinstance(clip, (list, tuple)) and len(clip) == 2:
                x = np.clip(x, float(clip[0]), float(clip[1]))
            zc = rule.get("zscore")
            if isinstance(zc, dict):
                masked = bool(zc.get("masked", True))
                mask_gt = float(zc.get("mask_gt", float("-inf")))
                eps = float(zc.get("eps", 1e-6))
                min_count = int(zc.get("min_count", 16))
                if masked:
                    m = x > mask_gt
                    vals = x[m] if int(m.sum()) >= min_count else x.reshape(-1)
                else:
                    vals = x.reshape(-1)
                mu = vals.mean()
                sd = max(vals.std(), eps)
                x = (x - mu) / sd
            out[..., ci] = x
        return out

    mean_a = np.zeros(c, np.float32) if mean is None else np.asarray(mean, np.float32)
    std_a = np.ones(c, np.float32) if std is None else np.asarray(std, np.float32)
    if mean_a.size == 1:
        mean_a = np.repeat(mean_a, c)
    if std_a.size == 1:
        std_a = np.repeat(std_a, c)
    if mean_a.size != c or std_a.size != c:
        raise RuntimeError(f"[transforms] mean/std length != C={c}")
    return (img - mean_a) / std_a


def _infer_label_kind(lbl: np.ndarray, expected_label_channels: Optional[int]) -> str:
    """raw: [D,H,W] or [D,H,W,1]; region: [D,H,W,N]."""
    if lbl.ndim == 3:
        kind = "raw"
    elif lbl.ndim == 4:
        n = int(lbl.shape[-1])
        if expected_label_channels is not None and expected_label_channels > 0:
            kind = "region"
        else:
            kind = "raw" if n == 1 else "region"
    else:
        raise ValueError(f"[transforms] label ndim must be 3 or 4, got {lbl.ndim}")

    if expected_label_channels is not None:
        if expected_label_channels == 0:
            if lbl.ndim == 4 and int(lbl.shape[-1]) != 1:
                raise ValueError(
                    f"[transforms] expected raw label, got region with N={lbl.shape[-1]}"
                )
            kind = "raw"
        elif expected_label_channels > 0:
            if lbl.ndim != 4:
                raise ValueError(f"[transforms] expected region label [D,H,W,N], got {lbl.shape}")
            if int(lbl.shape[-1]) != expected_label_channels:
                raise ValueError(
                    f"[transforms] expected region channels N={expected_label_channels}, "
                    f"got N={lbl.shape[-1]}"
                )
            kind = "region"
    return kind


def _check_spatial(name: str, arr: np.ndarray, spatial: Tuple[int, int, int]) -> None:
    got = tuple(int(x) for x in arr.shape[:3])
    if got != spatial:
        raise ValueError(
            f"[transforms] {name} spatial mismatch: got {got}, expected {spatial}. "
            f"This pipeline assumes OFFLINE preprocessing fixed shapes; no online "
            f"resize/crop/pad is performed."
        )


class SegTransform:
    """Callable (image, label, rng) -> (image, label) with reference semantics.

    image in: [D,H,W,C] float32; label in: [D,H,W] raw ids or [D,H,W,N] region.
    """

    def __init__(
        self,
        *,
        split: str,
        normalize: bool = True,
        geom_aug: bool = True,
        intensity_aug: bool = True,
        mean: Optional[Sequence[float]] = None,
        std: Optional[Sequence[float]] = None,
        expected_label_channels: Optional[int] = None,
        region_label_as_float: bool = True,
        image_size: Optional[Sequence[int]] = None,
        intensity_policy: Any = None,
        channel_names: Optional[Sequence[str]] = None,
        on_device: bool = False,
        rot_prob: float = 0.3,
        rot_max_k: int = 3,
        int_scale: float = 0.1,
        int_shift: float = 0.1,
        int_prob: float = 0.5,
        modality_dropout: Any = None,
    ):
        split = str(split).lower()
        self.is_train = split == "train"
        self.geom_aug = bool(geom_aug) and self.is_train
        self.intensity_aug = bool(intensity_aug) and self.is_train
        self.normalize = bool(normalize)
        self.on_device = bool(on_device)
        self.mean = mean
        self.std = std
        self.expected_label_channels = expected_label_channels
        self.region_label_as_float = bool(region_label_as_float)
        self.intensity_policy = _to_plain_dict(intensity_policy)
        self.channel_names = list(channel_names) if channel_names is not None else None
        self.rot_prob = float(rot_prob)
        self.rot_max_k = int(rot_max_k)
        self.int_scale = float(int_scale)
        self.int_shift = float(int_shift)
        self.int_prob = float(int_prob)
        # train-time modality dropout (missing-modality robustness): a
        # DEVICE-side augmentation inside the train step — the remedy
        # for missing-modality deployment (adaptation-time dropout cannot
        # recreate absent signal; measured in scripts/validate_tta_brats.py)
        md = _to_plain_dict(modality_dropout) or {}
        self.modality_dropout_enabled = bool(md.get("enabled", False)) and self.is_train
        self.modality_dropout_prob = float(md.get("prob", 0.25))
        if self.modality_dropout_enabled and not self.on_device:
            raise ValueError(
                "[transforms] modality_dropout is an on-device augmentation; "
                "set training.data.transforms.on_device=true"
            )

        self.expected_spatial: Optional[Tuple[int, int, int]] = None
        if image_size is not None:
            if len(list(image_size)) != 3:
                raise ValueError(f"[transforms] image_size must be [D,H,W], got {list(image_size)}")
            self.expected_spatial = tuple(int(x) for x in image_size)

    # what still must run on device when on_device=True
    def device_spec(self) -> Dict[str, Any]:
        return {
            "normalize": self.normalize and self.on_device,
            "intensity_policy": self.intensity_policy,
            "channel_names": self.channel_names,
            "mean": self.mean,
            "std": self.std,
            "intensity_aug": self.intensity_aug and self.on_device,
            "int_scale": self.int_scale,
            "int_shift": self.int_shift,
            "int_prob": self.int_prob,
            "modality_dropout": self.modality_dropout_enabled,
            "modality_dropout_prob": self.modality_dropout_prob,
        }

    def __call__(
        self,
        image: np.ndarray,
        label: np.ndarray,
        rng: Optional[np.random.Generator] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        if image.ndim != 4:
            raise ValueError(f"[transforms] expect image [D,H,W,C], got {image.shape}")
        if self.expected_spatial is not None:
            _check_spatial("image", image, self.expected_spatial)

        kind = _infer_label_kind(label, self.expected_label_channels)
        lbl = label if label.ndim == 4 else label[..., None]
        if self.expected_spatial is not None:
            _check_spatial("label", lbl, self.expected_spatial)

        img = image

        # ---- geometric aug (rot90 on H,W axes; reference transforms.py:96-105)
        if self.geom_aug and rng is not None:
            if rng.random() < self.rot_prob:
                k = int(rng.integers(1, self.rot_max_k + 1))
                img = np.rot90(img, k=k, axes=(1, 2)).copy()
                lbl = np.rot90(lbl, k=k, axes=(1, 2)).copy()

        # ---- restore label dtype/shape ----
        if kind == "raw":
            lbl_out: np.ndarray = lbl[..., 0].astype(np.int64)
        else:
            lbl_out = lbl.astype(np.float32) if self.region_label_as_float else lbl

        # ---- normalization (+ intensity aug after) ----
        if self.normalize and not self.on_device:
            img = normalize_host(
                img,
                intensity_policy=self.intensity_policy,
                channel_names=self.channel_names,
                mean=self.mean,
                std=self.std,
            )
        if self.intensity_aug and not self.on_device and rng is not None:
            if rng.random() < self.int_prob:
                factor = 1.0 + rng.uniform(-self.int_scale, self.int_scale)
                img = img * factor
            if rng.random() < self.int_prob:
                offset = rng.uniform(-self.int_shift, self.int_shift)
                img = img + offset

        return np.ascontiguousarray(img, dtype=np.float32), lbl_out


def get_seg_transforms(
    *,
    ndim: int,
    split: str,
    normalize: bool = True,
    geom_aug: bool = True,
    intensity_aug: bool = True,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    expected_label_channels: Optional[int] = None,
    region_label_as_float: bool = True,
    image_size: Optional[Sequence[int]] = None,
    intensity_policy: Any = None,
    channel_names: Optional[Sequence[str]] = None,
    on_device: bool = False,
    modality_dropout: Any = None,
) -> SegTransform:
    """Unified entry (3D only), API parity with reference transforms.py:344-382."""
    if ndim != 3:
        raise ValueError(f"get_seg_transforms currently only supports 3D (ndim=3). Got ndim={ndim}")
    return SegTransform(
        split=split,
        normalize=normalize,
        geom_aug=geom_aug,
        intensity_aug=intensity_aug,
        mean=mean,
        std=std,
        expected_label_channels=expected_label_channels,
        region_label_as_float=region_label_as_float,
        image_size=image_size,
        intensity_policy=intensity_policy,
        channel_names=channel_names,
        on_device=on_device,
        modality_dropout=modality_dropout,
    )
