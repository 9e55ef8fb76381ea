"""Fleet-level analytics over ``SimReport``.

Pure reductions — no simulator state — so they apply equally to a
monolithic ``SimScheduler`` report and a sharded ``FleetResult.report``:

- :func:`percentile` / :func:`jct_stats`: distribution summaries with
  linear interpolation (numpy-free; the sim layer stays stdlib-only).
- :func:`per_class_jct`: p50/p99 JCT per tenant class (default: the
  task's priority), the paper's hi-vs-lo protection evidence at scale.
- :func:`miss_rate_by_class`: deadline-miss counts and rates per class;
  points on a miss-rate-vs-load curve when swept over utilizations.
- :func:`utilization_histogram`: per-device utilization histogram —
  fleet imbalance at a glance.
- :func:`fleet_summary`: one JSON-ready dict combining all of the above
  (what ``benchmarks/bench_fleet.py`` emits per scenario).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.scheduler import SimReport
from repro_torch.core.task import TaskSpec

__all__ = ["percentile", "jct_stats", "per_class_jct",
           "miss_rate_by_class", "utilization_histogram", "fleet_summary"]

ClassOf = Callable[[TaskSpec], object]


def _default_class(spec: TaskSpec) -> object:
    return spec.priority


def percentile(values: Sequence[float], q: float) -> float:
    """q-th percentile (0..100) with linear interpolation; nan if empty."""
    if not values:
        return math.nan
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    s = sorted(values)
    if len(s) == 1:
        return s[0]
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    frac = pos - lo
    if lo + 1 >= len(s):
        return s[-1]
    return s[lo] * (1.0 - frac) + s[lo + 1] * frac


def jct_stats(values: Sequence[float]) -> Dict[str, float]:
    """count / mean / p50 / p99 / max summary of a JCT sample."""
    if not values:
        return {"count": 0, "mean": math.nan, "p50": math.nan,
                "p99": math.nan, "max": math.nan}
    return {"count": len(values),
            "mean": sum(values) / len(values),
            "p50": percentile(values, 50.0),
            "p99": percentile(values, 99.0),
            "max": max(values)}


def per_class_jct(specs: Sequence[TaskSpec], report: SimReport,
                  class_of: Optional[ClassOf] = None
                  ) -> Dict[object, Dict[str, float]]:
    """Per-class JCT distributions. Tasks that never completed
    (``completion < 0``, e.g. cancelled) are excluded."""
    class_of = class_of or _default_class
    buckets: Dict[object, List[float]] = {}
    for spec, res in zip(specs, report.results):
        if res is None or res.completion < 0:
            continue
        buckets.setdefault(class_of(spec), []).append(res.jct)
    return {c: jct_stats(v) for c, v in sorted(buckets.items(),
                                               key=lambda kv: str(kv[0]))}


def miss_rate_by_class(specs: Sequence[TaskSpec], report: SimReport,
                       class_of: Optional[ClassOf] = None
                       ) -> Dict[object, Dict[str, float]]:
    """Deadline tally per class: tagged / missed / miss_rate. Only
    deadline-tagged tasks count; classes with none are omitted."""
    class_of = class_of or _default_class
    tally: Dict[object, List[int]] = {}
    for spec, res in zip(specs, report.results):
        if spec.deadline is None or res is None:
            continue
        t = tally.setdefault(class_of(spec), [0, 0])
        t[0] += 1
        if res.completion < 0 or res.completion > spec.deadline:
            t[1] += 1
    return {c: {"tagged": tagged, "missed": missed,
                "miss_rate": missed / tagged}
            for c, (tagged, missed) in sorted(tally.items(),
                                              key=lambda kv: str(kv[0]))}


def utilization_histogram(report: SimReport, bins: int = 10
                          ) -> Dict[str, List[float]]:
    """Histogram of per-device utilization over [0, 1]: ``edges`` has
    ``bins + 1`` entries, ``counts`` has ``bins`` (devices above 1.0 —
    impossible for a serial timeline — clamp into the last bin)."""
    if bins <= 0:
        raise ValueError(f"need bins >= 1, got {bins}")
    utils = report.per_device_utilization()
    edges = [i / bins for i in range(bins + 1)]
    counts = [0] * bins
    for u in utils:
        counts[min(int(u * bins), bins - 1)] += 1
    return {"edges": edges, "counts": counts}


def fleet_summary(specs: Sequence[TaskSpec], report: SimReport,
                  class_of: Optional[ClassOf] = None,
                  bins: int = 10) -> Dict[str, object]:
    """JSON-ready rollup of one fleet scenario."""
    return {
        "tasks": len(specs),
        "devices": report.devices,
        "events": report.events,
        "makespan": report.makespan,
        "utilization": report.utilization(),
        "fills": report.fills,
        "steals": report.steals,
        "deadline_misses": report.deadline_misses,
        "deadlines_tagged": report.deadlines_tagged,
        "deadline_miss_rate": report.deadline_miss_rate,
        "jct_by_class": per_class_jct(specs, report, class_of),
        "miss_by_class": miss_rate_by_class(specs, report, class_of),
        "util_histogram": utilization_histogram(report, bins=bins),
    }
