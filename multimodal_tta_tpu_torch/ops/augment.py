"""On-device data augmentation of the train step (the port of
``multimodal_tta_tpu/ops/augment.py``): the per-sample intensity scale and
shift, modality dropout and random 90-degree rotations.

Each augmentation is split in two: ``*_draws`` takes the random numbers
from an explicit ``torch.Generator``, and ``apply_*`` is a function of the
input and the draws only, so a test can feed both packages the same draws.
Layout: channels-last ``[B, *spatial, C]``, as every public function of the
port.

The test-time adapters take their random numbers the same way, described by
a draw spec: a list of JSON-able entries, one per kind of draw, in the order
they are taken from the generator (``make_draws``). ``group_draws`` gives a
step the dict of draws its code reads; ``flatten_draws`` is its inverse. The
serving artifact records the spec, so a runtime makes a batch's draws with
this module alone (``serving/export.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch


def _per_sample(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.to(device=x.device, dtype=x.dtype).reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def intensity_scale_shift_draws(
    b: int,
    generator: torch.Generator,
    *,
    scale: float = 0.1,
    shift: float = 0.1,
    prob: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample ``(factor [b], offset [b])``: a factor in
    ``[1 - scale, 1 + scale)`` with probability ``prob`` (else 1) and an
    offset in ``[-shift, shift)`` with probability ``prob`` (else 0), on the
    generator's device."""
    u = torch.rand((4, b), generator=generator, device=generator.device)
    factor = torch.where(u[0] < prob, 1.0 + (2.0 * u[1] - 1.0) * scale, 1.0)
    offset = torch.where(u[2] < prob, (2.0 * u[3] - 1.0) * shift, 0.0)
    return factor, offset


def apply_intensity_scale_shift(x: torch.Tensor, factor: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """``x * factor + offset`` with one factor and offset per sample."""
    return x * _per_sample(factor, x) + _per_sample(offset, x)


def rand_intensity_scale_shift(
    x: torch.Tensor,
    generator: torch.Generator,
    *,
    scale: float = 0.1,
    shift: float = 0.1,
    prob: float = 0.5,
) -> torch.Tensor:
    """Per-sample random multiplicative scale and additive shift, each applied
    with probability ``prob`` (reference: RandScaleIntensity/RandShiftIntensity
    with factors/offsets 0.1, prob 0.5 — transforms.py:109-116).

    x: [B, ...]; randomness is per-sample."""
    factor, offset = intensity_scale_shift_draws(x.shape[0], generator, scale=scale,
                                                 shift=shift, prob=prob)
    return apply_intensity_scale_shift(x, factor, offset)


def modality_dropout_draws(b: int, m: int, generator: torch.Generator, *, prob: float = 0.25) -> torch.Tensor:
    """``drop [b, m]`` (bool): each modality of each sample dropped with
    probability ``prob``, except one modality per sample, drawn uniformly,
    which is always kept."""
    drop = torch.rand((b, m), generator=generator, device=generator.device) < prob
    keep = torch.randint(0, m, (b,), generator=generator, device=generator.device)
    drop[torch.arange(b, device=drop.device), keep] = False
    return drop


def apply_modality_dropout(x: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    """Zero the modalities (last axis) of each sample where ``drop`` is set."""
    b, m = x.shape[0], x.shape[-1]
    mask = drop.to(x.device).reshape((b,) + (1,) * (x.dim() - 2) + (m,))
    return torch.where(mask, torch.zeros((), dtype=x.dtype, device=x.device), x)


def modality_dropout(x: torch.Tensor, generator: torch.Generator, *, prob: float = 0.25) -> torch.Tensor:
    """Randomly zero whole modalities (channels) per sample, guaranteeing at
    least one modality survives (missing-modality-robust training).

    x: [B, ..., M]."""
    return apply_modality_dropout(x, modality_dropout_draws(x.shape[0], x.shape[-1], generator, prob=prob))


def rot90_draws(b: int, generator: torch.Generator, *, prob: float = 0.3, max_k: int = 3) -> torch.Tensor:
    """``k [b]`` (int64): a number of quarter turns in ``[1, max_k]`` with
    probability ``prob``, else 0, per sample, on the generator's device."""
    do = torch.rand(b, generator=generator, device=generator.device) < prob
    ks = torch.randint(1, max_k + 1, (b,), generator=generator, device=generator.device)
    return torch.where(do, ks, torch.zeros_like(ks))


def apply_rand_rot90(image: torch.Tensor, label: torch.Tensor, k: torch.Tensor,
                     axes: Tuple[int, int] = (2, 3)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate each sample of ``image`` and ``label`` by ``k[i]`` quarter turns
    (``jnp.rot90`` / ``torch.rot90``'s direction: from the first axis
    towards the second) on the square plane ``axes``; ``k`` is clamped to
    [0, 3] as the reference's ``lax.switch`` clamps its index. Each of the
    four rotations of the batch is selected per sample with ``torch.where``,
    so nothing is read back to the host."""
    if image.shape[axes[0]] != image.shape[axes[1]]:
        raise ValueError(f"rand_rot90 needs square plane on axes {axes}: got {tuple(image.shape)}")
    k = k.to(image.device).clamp(0, 3)
    out = []
    for x in (image, label):
        kx = k.reshape((-1,) + (1,) * (x.dim() - 1))
        y = x
        for turns in (1, 2, 3):
            y = torch.where(kx == turns, torch.rot90(x, turns, dims=axes), y)
        out.append(y)
    return out[0], out[1]


def rand_rot90(
    image: torch.Tensor,
    label: torch.Tensor,
    generator: torch.Generator,
    *,
    prob: float = 0.3,
    max_k: int = 3,
    axes: Tuple[int, int] = (2, 3),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample random 90-degree rotations of image and label on the (H, W)
    plane (batch layout [B, D, H, W, C]; ``axes=(2, 3)``), which must be
    square, as the reference requires (MONAI's RandRotate90d in effect)."""
    return apply_rand_rot90(image, label, rot90_draws(image.shape[0], generator, prob=prob, max_k=max_k), axes)


# ---- the test-time adapters' draws ------------------------------------------

View = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def restore_draws(shapes: Sequence[Sequence[int]], prob: float, generator: torch.Generator) -> List[torch.Tensor]:
    """One bool mask per adapted tensor: True where the element snaps back
    to its source value (Bernoulli ``prob`` each)."""
    return [torch.rand(tuple(s), generator=generator, device=generator.device) < prob for s in shapes]


def window_draws(
    n_windows: int,
    n_valid: int,
    spatial: Sequence[int],
    roi: Sequence[int],
    generator: torch.Generator,
) -> torch.Tensor:
    """``[n_windows, 4]`` int64 rows ``(sample, d0, h0, w0)``: a valid sample
    index and the ROI's corner, uniform over the positions that fit."""
    dev = generator.device
    n = max(int(n_valid), 1)
    cols = [torch.randint(0, n, (n_windows,), generator=generator, device=dev)]
    for size, r in zip(spatial, roi):
        cols.append(torch.randint(0, max(int(size) - int(r), 0) + 1, (n_windows,),
                                  generator=generator, device=dev))
    return torch.stack(cols, dim=1)


def view_draws(shape: Sequence[int], n: int, generator: torch.Generator, *, scale: float, shift: float,
               noise: float) -> List[View]:
    """``n`` augmented views' random numbers: per view a per-sample intensity
    factor and offset (always applied) and, when ``noise > 0``, a standard
    normal tensor of the input's shape."""
    out = []
    for _ in range(n):
        factor, offset = intensity_scale_shift_draws(shape[0], generator, scale=scale, shift=shift, prob=1.0)
        z = torch.randn(tuple(shape), generator=generator, device=generator.device) if noise > 0.0 else None
        out.append((factor, offset, z))
    return out


# the keys every step dict has (None when the step draws no such thing)
STEP_KEYS = ("restore", "drop", "windows", "cons")


def _entry_tensors(e: Dict[str, Any]) -> int:
    """How many flat tensors one spec entry makes."""
    kind = e["kind"]
    if kind == "bernoulli":
        return len(e["shapes"])
    if kind == "scale_shift":
        return 2
    if kind == "views":
        return e["n"] * (3 if e["noise"] > 0.0 else 2)
    if kind in ("dropout", "windows"):
        return 1
    raise ValueError(f"unknown draw kind {kind!r}")


def _make_entry(e: Dict[str, Any], g: torch.Generator, n_valid: int):
    """One entry's draws, grouped as the adapters read them."""
    kind = e["kind"]
    if kind == "bernoulli":
        return restore_draws(e["shapes"], e["p"], g)
    if kind == "dropout":
        return modality_dropout_draws(e["b"], e["m"], g, prob=e["p"])
    if kind == "windows":
        return window_draws(e["n"], n_valid, e["spatial"], e["roi"], g)
    if kind == "scale_shift":
        return intensity_scale_shift_draws(e["n"], g, scale=e["scale"], shift=e["shift"], prob=1.0)
    if kind == "views":
        return view_draws(e["shape"], e["n"], g, scale=e["scale"], shift=e["shift"], noise=e["noise"])
    raise ValueError(f"unknown draw kind {kind!r}")


def _flat_entry(e: Dict[str, Any], value) -> List[torch.Tensor]:
    kind = e["kind"]
    if kind == "bernoulli":
        return list(value)
    if kind == "scale_shift":
        return [value[0], value[1]]
    if kind == "views":
        return [t for v in value for t in (v if e["noise"] > 0.0 else v[:2])]
    return [value]


def _group_entry(e: Dict[str, Any], flat: Sequence[torch.Tensor]):
    kind = e["kind"]
    if kind == "bernoulli":
        return list(flat)
    if kind == "scale_shift":
        return flat[0], flat[1]
    if kind == "views":
        k = 3 if e["noise"] > 0.0 else 2
        return [(flat[i], flat[i + 1], flat[i + 2] if k == 3 else None) for i in range(0, len(flat), k)]
    return flat[0]


def _entries(spec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every entry of a batch spec ``{"steps": [entries per step], "post":
    entries or None}`` in generator order."""
    return [e for step in spec["steps"] for e in step] + list(spec.get("post") or [])


def make_draws(spec: Dict[str, Any], generator: torch.Generator, n_valid: int) -> List[torch.Tensor]:
    """A batch's draws as a flat list of tensors on the generator's device,
    taken in the spec's order; ``n_valid`` bounds the window samples."""
    return [t for e in _entries(spec) for t in _flat_entry(e, _make_entry(e, generator, n_valid))]


def group_draws(spec: Dict[str, Any], flat: Sequence[torch.Tensor]) -> Dict[str, Any]:
    """The flat draws of ``spec`` as the adapters read them: ``{"steps":
    [one dict per step, ``STEP_KEYS`` plus the step's own keys], "post": the
    post entry's value or None}``."""
    if len(flat) != sum(_entry_tensors(e) for e in _entries(spec)):
        raise ValueError(f"the draws hold {len(flat)} tensors, the spec takes "
                         f"{sum(_entry_tensors(e) for e in _entries(spec))}")
    pos = 0

    def take(e):
        nonlocal pos
        k = _entry_tensors(e)
        pos += k
        return _group_entry(e, flat[pos - k:pos])

    steps = []
    for step in spec["steps"]:
        d = dict.fromkeys(STEP_KEYS)
        d.update({e["key"]: take(e) for e in step})
        steps.append(d)
    post = spec.get("post")
    return {"steps": steps, "post": take(post[0]) if post else None}


def flatten_draws(spec: Dict[str, Any], batch: Dict[str, Any]) -> List[torch.Tensor]:
    """The inverse of ``group_draws``: a batch's draws (as ``batch_draws``
    gives them) as the flat list of ``spec``."""
    out = []
    for step, d in zip(spec["steps"], batch["steps"]):
        for e in step:
            out += _flat_entry(e, d[e["key"]])
    post = spec.get("post")
    if post:
        out += _flat_entry(post[0], batch["post"])
    return out
