"""Streaming continual TTA over ordered domain shifts (the port of
``multimodal_tta_tpu/tta/stream.py``).

``StreamTTAController`` owns the adapted state across an endless test
stream whose domain changes over time:

  Reset policy (``policy``):
    - ``"episodic"``               re-anchor to source before every batch
    - ``"continual"``              never re-anchor (plain online adaptation)
    - ``"reset_on_domain_change"`` continual within a domain, re-anchor at
                                   domain boundaries

  Collapse guard (``guard=True``): an entropy watchdog. The final-step
  adaptation entropy below ``entropy_floor_ratio * e0`` (e0: the stream's
  FIRST pre-adaptation entropy) triggers a re-anchor.
  ``periodic_reanchor_every`` re-anchors every K batches without a trigger.

  Entropy-gated serving (``gate=True``): the controller starts in a
  forward-only mode (one plain forward per batch, no backward) and watches
  the PLAIN volume-mean entropy that forward yields. When it crosses the
  gate threshold (absolute ``gate_threshold``, or ``gate_ratio`` times the
  first batch's), the controller escalates: the SAME batch is re-served
  adapted and every later batch adapts. Each re-anchor drops back to the
  forward mode.

A re-anchor here is ``adapter.restore()`` (the source params) plus
``adapter.reset_optimizer()`` (momentum, and what the method carries: SAR's
entropy EMA, CoTTA's teacher); the reference gets the same by handing back
its source ``TrainState``. Over ranks (the adapter's ``mesh``) ``step``
takes the global batch, pads it with zero rows to a multiple of the data
axis (``n_valid`` masks them out), adapts on this rank's rows and returns
the prediction of the whole padded batch, gathered from the ranks.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..conf.node import ConfigNode
from ..utils.config import get_config
from ..utils.logger import get_logger

POLICIES = ("episodic", "continual", "reset_on_domain_change")


class StreamTTAController:
    def __init__(
        self,
        adapter,
        source_state,
        *,
        threshold: float,
        policy: str = "continual",
        guard: bool = False,
        entropy_floor_ratio: float = 0.2,
        periodic_reanchor_every: int = 0,
        predict_mode: str = "inline",
        gate: bool = False,
        gate_ratio: float = 1.5,
        gate_threshold: Optional[float] = None,
    ):
        if str(policy) not in POLICIES:
            raise ValueError(f"[stream] unknown policy {policy!r}; known: {POLICIES}")
        if adapter.episodic:
            raise ValueError(
                "[stream] the controller owns reset policy — build the "
                "adapter with episodic=false and choose policy='episodic' "
                "here instead"
            )
        if not hasattr(adapter, "make_adapt_predict_fn"):
            raise ValueError(
                f"[stream] adapter {type(adapter).__name__} has no fused "
                f"adapt+predict serving path (make_adapt_predict_fn) — the "
                f"streaming protocol requires it (tta method 'tent')"
            )
        self.adapter = adapter
        self.policy = str(policy)
        self.guard = bool(guard)
        self.floor_ratio = float(entropy_floor_ratio)
        self.period = int(periodic_reanchor_every or 0)
        self.logger = get_logger()

        self._ap = adapter.make_adapt_predict_fn(
            source_state, threshold=float(threshold), predict_mode=predict_mode
        )
        self.state = source_state
        self._e0: Optional[float] = None
        self._last_domain: Optional[str] = None
        self._n_batches = 0
        self.n_reanchors = 0
        self.reanchor_log = []  # (batch_idx, reason)

        self.gate = bool(gate)
        self.gate_ratio = float(gate_ratio)
        self.gate_threshold = None if gate_threshold is None else float(gate_threshold)
        self._gate_ref: Optional[float] = None
        self.mode = "forward" if self.gate else "adapt"
        self.n_forward_batches = 0
        self.n_adapt_batches = 0
        self.escalation_log = []  # (batch_idx, entropy, threshold)
        self._fp = None
        if self.gate:
            if not hasattr(adapter, "make_forward_predict_fn"):
                raise ValueError(
                    f"[stream] gate=true needs the adapter's forward-only "
                    f"serving path (make_forward_predict_fn) — "
                    f"{type(adapter).__name__} has none"
                )
            self._fp = adapter.make_forward_predict_fn(source_state, threshold=float(threshold))

    @classmethod
    def from_config(cls, adapter, source_state, config, *, threshold: float):
        scfg = get_config(config, "tta.stream", ConfigNode())
        period = int(get_config(scfg, "periodic_reanchor_every", 0))
        # `gate.reprobe_every` is an alias of the periodic re-anchor (a
        # re-anchor drops the gate back to forward mode); both set -> ambiguous,
        # set with the gate off -> an error rather than a silent re-anchoring
        reprobe = int(get_config(scfg, "gate.reprobe_every", 0))
        if reprobe:
            if not bool(get_config(scfg, "gate.enabled", False)):
                raise ValueError(
                    "[stream] tta.stream.gate.reprobe_every is set but "
                    "gate.enabled is false — use "
                    "tta.stream.periodic_reanchor_every for ungated streams"
                )
            if period and period != reprobe:
                raise ValueError(
                    "[stream] tta.stream.periodic_reanchor_every and "
                    "tta.stream.gate.reprobe_every are aliases — set one "
                    f"(got {period} vs {reprobe})"
                )
            period = reprobe
        gate_abs = get_config(scfg, "gate.threshold", None)
        if gate_abs is not None and str(get_config(config, "tta.entropy_focus", "all")) != "all":
            warnings.warn(
                "[stream] tta.stream.gate.threshold is absolute and is "
                "compared against the PLAIN volume-mean entropy (not the "
                f"entropy_focus={get_config(config, 'tta.entropy_focus')!r} "
                "objective). Thresholds calibrated before the round-4 gate "
                "signal change need re-calibration; gate.ratio mode "
                "self-calibrates and is unaffected.",
                stacklevel=2,
            )
        return cls(
            adapter,
            source_state,
            threshold=threshold,
            policy=str(get_config(scfg, "policy", "continual")),
            guard=bool(get_config(scfg, "guard", False)),
            entropy_floor_ratio=float(get_config(scfg, "entropy_floor_ratio", 0.2)),
            periodic_reanchor_every=period,
            predict_mode=str(get_config(config, "tta.predict", "inline")),
            gate=bool(get_config(scfg, "gate.enabled", False)),
            gate_ratio=float(get_config(scfg, "gate.ratio", 1.5)),
            gate_threshold=get_config(scfg, "gate.threshold", None),
        )

    # ------------------------------------------------------------------
    def reanchor(self, reason: str = "manual") -> None:
        """Back to the source model: params, optimizer momentum and the
        method's carried state."""
        self.adapter.restore()
        self.adapter.reset_optimizer()
        if self.gate:
            self.mode = "forward"
        self.n_reanchors += 1
        self.reanchor_log.append((self._n_batches, reason))
        self.logger.info(f"[stream] re-anchored to source at batch {self._n_batches} ({reason})")

    def step(self, image, n_valid: int, domain: Optional[str] = None) -> Tuple[Any, Dict[str, Any]]:
        """Adapt + predict one stream batch; returns (pred, info)."""
        if self.policy == "episodic":
            self.reanchor("episodic")
            self.reanchor_log.pop()  # per-batch resets aren't events
            self.n_reanchors -= 1
        elif self.policy == "reset_on_domain_change":
            if domain is not None and self._last_domain is not None and domain != self._last_domain:
                self.reanchor(f"domain {self._last_domain} -> {domain}")
        self._last_domain = domain

        image = torch.as_tensor(image)
        mesh = getattr(self.adapter, "mesh", None)
        if mesh is not None:
            # the ranks need the batch divisible by the data axis; pad with
            # zero rows, which n_valid masks out of the objective
            b = image.shape[0]
            if b % mesh.data:
                pad = image.new_zeros((mesh.data - b % mesh.data,) + tuple(image.shape[1:]))
                image = torch.cat([image, pad])
            image = mesh.local(image)  # its rows (and, over a space axis, its depth slab)
        if self.gate and self.mode == "forward":
            pred, ent_obj, ent_gate = self._fp(self.state, image, int(n_valid))
            if mesh is not None:
                pred = mesh.gather(pred)
            if self._gate_ref is None:
                self._gate_ref = ent_gate
            if self._e0 is None:
                self._e0 = ent_obj
            thresh = self.gate_threshold if self.gate_threshold is not None else self.gate_ratio * self._gate_ref
            if ent_gate <= thresh:
                self._n_batches += 1
                self.n_forward_batches += 1
                return pred, {
                    "entropy_first": ent_obj,
                    "entropy_final": ent_obj,
                    "gate_entropy": ent_gate,
                    "mode": "forward",
                    "domain": domain,
                    "reanchored": False,
                    "reason": None,
                }
            self.mode = "adapt"
            self.escalation_log.append((self._n_batches, ent_gate, float(thresh)))
            self.logger.info(
                f"[stream] gate escalated at batch {self._n_batches}: "
                f"gate entropy {ent_gate:.4g} > {float(thresh):.4g} "
                f"(objective entropy {ent_obj:.4g})"
            )

        # the adapter's early-stop floor is anchored at the STREAM's first
        # pre-adaptation entropy
        floor = None
        if getattr(self.adapter, "early_stop", False) and self._e0 is not None:
            floor = float(self.adapter.early_stop_ratio) * self._e0
        self.n_adapt_batches += 1
        self.state, pred = self._ap(self.state, image, int(n_valid), ent_floor=floor)
        if mesh is not None:
            pred = mesh.gather(pred)
        ents = self.adapter._last_ents
        ent_first, ent_final = torch.stack([ents[0], ents[-1]]).tolist()  # one device read
        if self._e0 is None:
            self._e0 = ent_first
        self._n_batches += 1

        info = {
            "entropy_first": ent_first,
            "entropy_final": ent_final,
            "gate_entropy": None,
            "mode": "adapt",
            "domain": domain,
            "reanchored": False,
            "reason": None,
        }
        if self.guard and self._e0 > 0 and ent_final < self.floor_ratio * self._e0:
            info["reanchored"] = True
            info["reason"] = (
                f"entropy watchdog: {ent_final:.4g} < "
                f"{self.floor_ratio:.2f} * e0={self._e0:.4g}"
            )
            self.reanchor(info["reason"])
        elif self.period and self._n_batches % self.period == 0:
            info["reanchored"] = True
            info["reason"] = f"periodic every {self.period}"
            self.reanchor(info["reason"])
        return pred, info


def binary_dice_per_case(pred, label, n_valid: int):
    """Per-case binary Dice with empty-GT gating (cases with empty ground
    truth don't contribute), on the host in f64."""
    if isinstance(pred, torch.Tensor):
        pred = pred.cpu().numpy()
    if isinstance(label, torch.Tensor):
        label = label.cpu().numpy()
    out = []
    p = np.asarray(pred)[:n_valid].astype(np.float64)
    y = np.asarray(label)[:n_valid].astype(np.float64)
    for i in range(n_valid):
        if y[i].sum() > 0:
            out.append(2.0 * (p[i] * y[i]).sum() / max(p[i].sum() + y[i].sum(), 1.0))
    return out


def evaluate_stream(controller: StreamTTAController, stream) -> Dict[str, Any]:
    """Run an ordered (domain, batch) stream through the controller and
    report Dice overall, per domain, and per stream position (the per-domain
    keys of seg_eval's ``dom/<domain>/...`` schema)."""
    per_domain: Dict[str, list] = {}
    positions = []
    for pos, (domain, batch) in enumerate(stream):
        n = int(batch.get("_n_valid", batch["image"].shape[0]))
        pred, info = controller.step(batch["image"], n, domain=domain)
        ds = binary_dice_per_case(pred, batch["label"], n)
        per_domain.setdefault(str(domain), []).extend(ds)
        positions.append(
            {
                "pos": pos,
                "domain": str(domain),
                "dice": round(float(np.mean(ds)), 4) if ds else None,
                "entropy": round(info["entropy_final"], 5),
                "mode": info.get("mode", "adapt"),
                "reanchored": bool(info["reanchored"]),
            }
        )
    alls = [d for v in per_domain.values() for d in v]
    metrics: Dict[str, Any] = {
        "avg_dc": round(float(np.mean(alls)), 4) if alls else 0.0,
        "n_cases": len(alls),
        "reanchors": controller.n_reanchors,
        "policy": controller.policy
        + ("+guard" if controller.guard else "")
        + ("+gate" if controller.gate else ""),
        "positions": positions,
    }
    if controller.gate:
        metrics["gate/forward_batches"] = controller.n_forward_batches
        metrics["gate/adapt_batches"] = controller.n_adapt_batches
        metrics["gate/escalations"] = [
            {"batch": b, "entropy": round(e, 5), "threshold": round(t, 5)}
            for b, e, t in controller.escalation_log
        ]
    for dom, v in per_domain.items():
        metrics[f"dom/{dom}/avg_dc"] = round(float(np.mean(v)), 4) if v else 0.0
    return metrics
