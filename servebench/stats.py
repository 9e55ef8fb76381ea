"""Latency statistics of a run, taken over every request due in the
window: a request that failed, was refused or never came back counts as
infinitely late."""
from __future__ import annotations

import math
from typing import List, Optional


def percentile(values: List[float], q: float) -> float:
    """The q-quantile (0 < q < 1) by linear interpolation between the
    order statistics at rank q * (n - 1)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    at = q * (len(v) - 1)
    lo, hi = math.floor(at), math.ceil(at)
    if v[hi] == math.inf:
        return math.inf
    return v[lo] + (v[hi] - v[lo]) * (at - lo)


def latency_ms(run, role: str, q: float) -> Optional[float]:
    """The q-quantile of the role's latencies, from each request's due
    time to its logits on the host; None where it is infinite."""
    lat = [(r.done - r.sent) if r.done is not None else math.inf
           for r in getattr(run, role)]
    if not lat:
        return None
    v = percentile(lat, q)
    return None if math.isinf(v) else 1e3 * v
