"""Kernel resource classes + the interference coefficient model.

FIKIT's BestPrioFit assumes a filler occupies the holder's idle gap for
free, but concurrent kernels slow each other down in ways that depend on
what resource each is bound by (cf. Tally's slowdown characterization and
the Gilman/Walls concurrency survey): a memory-bound filler inside a
memory-bound holder's gap contends for bandwidth and costs the holder
real time, eroding exactly the high-priority speedup the paper claims.

This module provides the two ingredients the scheduler needs:

- **Resource classes.** Every kernel is classified ``compute``-bound or
  ``memory``-bound by its roofline arithmetic intensity (FLOPs per byte
  accessed) against a per-architecture ridge point (peak FLOP/s divided
  by HBM bandwidth — the intensity where the roofline's two ceilings
  meet). ``classify_intensity`` is the single classification rule; the
  HLO cost layer (``repro_torch.launch.hlo_cost``) and the roofline benchmark
  both delegate to it, and simulator traces carry a ground-truth class
  on ``TraceKernel.kclass``. The class rides the kernel's profile
  (``TaskProfile.kclass`` -> ``ProfiledData.predict_class``) so the
  scheduler reads it with the same one-probe lookup it uses for SK.
  A kernel with no recorded class defaults to compute-bound — the
  conservative pre-classification behavior, pinned by test.

- **Interference coefficients.** ``InterferenceModel`` maps a
  ``(holder_class, filler_class)`` pair to the predicted slowdown factor
  the filler imposes while sharing the device with the holder's next
  kernel's working set (>= 1.0; 1.0 = free). The fill decision divides
  the idle gap by the pair's coefficient — a candidate fits only if its
  predicted duration times the coefficient still fits the gap — and the
  fill loop debits the gap by the same effective duration. Coefficients
  are refined live by ``repro_torch.core.online.OnlineMeasurement`` from
  observed-vs-predicted duration drift of matched fillers, committed in
  the same epochs as SK/SG (EMA, floor-clamped at 1.0).

The standing contract: with the model OFF (``interference=None`` on the
engines, or ``enabled=False``) every decision is bit-identical to the
pre-interference implementation — pinned by the randomized differential
suites in ``tests/test_policy_differential.py``.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional, Tuple

#: Resource-class labels (kept as plain strings: they round-trip through
#: profile JSON and appear in bench payloads).
COMPUTE_BOUND = "compute"
MEMORY_BOUND = "memory"
RESOURCE_CLASSES: Tuple[str, ...] = (COMPUTE_BOUND, MEMORY_BOUND)

ClassPair = Tuple[str, str]

#: Seed coefficients for a model built without measurements, shaped by
#: the concurrency literature: same-resource pairs contend hardest
#: (memory/memory worst — bandwidth is the scarcest shared resource),
#: cross-resource pairs overlap well (a compute-bound filler barely
#: slows a memory-bound holder).
DEFAULT_COEFFS: Dict[ClassPair, float] = {
    (MEMORY_BOUND, MEMORY_BOUND): 1.55,
    (COMPUTE_BOUND, COMPUTE_BOUND): 1.15,
    (COMPUTE_BOUND, MEMORY_BOUND): 1.25,
    (MEMORY_BOUND, COMPUTE_BOUND): 1.05,
}


def classify_intensity(flops: float, bytes_accessed: float,
                       ridge: float) -> str:
    """Roofline classification: compute-bound iff the arithmetic
    intensity (FLOPs per byte accessed) reaches the ridge point.

    ``bytes_accessed <= 0`` (no traffic recorded) classifies
    compute-bound — the conservative default, matching the unclassified
    fallback everywhere else."""
    if bytes_accessed <= 0:
        return COMPUTE_BOUND
    return (COMPUTE_BOUND if flops / bytes_accessed >= ridge
            else MEMORY_BOUND)


class InterferenceModel:
    """Per-class-pair slowdown coefficients for gap-fill scoring.

    ``coeff(holder_class, filler_class)`` is the factor by which the
    filler's device occupancy is predicted to stretch while the holder's
    gap is open; unknown pairs predict 1.0 (no interference). ``update``
    folds one epoch's observed batch-mean slowdown into a pair via EMA,
    clamped at the 1.0 floor (co-location is never modeled as a
    speedup — a ratio below 1.0 is measurement noise).

    ``enabled=False`` constructs the model but keeps every scoring seam
    on its plain path — the wired-but-off configuration the differential
    suite pins bit-identical to no model at all.
    """

    def __init__(self, coeffs: Optional[Mapping] = None, *,
                 enabled: bool = True):
        if coeffs is None:
            self._coeffs: Dict[ClassPair, float] = dict(DEFAULT_COEFFS)
        else:
            self._coeffs = {(str(k[0]), str(k[1])): float(v)
                            for k, v in coeffs.items()}
        self.enabled = enabled
        self.updates = 0

    def coeff(self, holder_class: str, filler_class: str) -> float:
        return self._coeffs.get((holder_class, filler_class), 1.0)

    def update(self, pair: ClassPair, batch: float, alpha: float) -> None:
        """EMA-fold one epoch's batch-mean observed slowdown into
        ``pair``, floor-clamped at 1.0."""
        old = self._coeffs.get(pair, 1.0)
        self._coeffs[pair] = max(1.0, (1.0 - alpha) * old + alpha * batch)
        self.updates += 1

    def snapshot(self) -> Dict[ClassPair, float]:
        """Copy of the current coefficient table (for persistence and
        bench payloads)."""
        return dict(self._coeffs)

    @staticmethod
    def coerce(spec) -> Optional["InterferenceModel"]:
        """Normalize the engines' ``interference=`` argument:
        None/False -> None (no model), True -> ``DEFAULT_COEFFS``,
        a model -> itself, a mapping -> a model over those coeffs."""
        if spec is None or spec is False:
            return None
        if spec is True:
            return InterferenceModel()
        if isinstance(spec, InterferenceModel):
            return spec
        if isinstance(spec, Mapping):
            return InterferenceModel(spec)
        raise TypeError(f"interference= expects None/bool/Mapping/"
                        f"InterferenceModel, got {spec!r}")
