"""The program's own spans, for the per-layer metrics that read them: the
rows the port's engine records, one per kernel request its device thread
ran (``repro_torch.spans``), on the clock the device trace is put on.

A program without that recorder gives no reading, and neither does a
ring that no longer holds the whole window. A row's role is told by its
priority, against the cell's mix. Device-idle time is the window less
``Trace.busy()``, intersected here with the rows' intervals.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Iterable, List, Optional, Tuple

from servebench.trace import Trace

Interval = Tuple[float, float]


def held(run) -> Optional[list]:
    """Every row the ring holds, oldest first, or None: where the program
    has no recorder, or where the oldest row held finished after the
    window opened (rows are recorded as they finish, so every row
    overwritten finished before the oldest one held)."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    rows = spans.rows()
    if not rows or rows[0].done >= run.t0:
        return None
    return rows


def _of(run, rows, role: Optional[str]) -> list:
    if role is None:
        return rows
    prio = run.cell.mix[role]["priority"]
    return [r for r in rows if r.priority == prio]


def window(run, role: Optional[str] = None) -> Optional[list]:
    """The rows whose ``start`` lies in the window (of ``role``'s service
    where one is named), or None."""
    rows = held(run)
    if rows is None:
        return None
    return _of(run, [r for r in rows if run.t0 <= r.start <= run.t1], role)


def requests(run, role: str) -> Optional[List[list]]:
    """``role``'s requests whose last segment ended in the window, each
    the rows of all its segments in order; a request the ring holds only
    in part is left out."""
    rows = held(run)
    if rows is None:
        return None
    rows = _of(run, rows, role)
    if not rows:
        return []
    n = 1 + max(r.seq for r in rows)
    by_instance = defaultdict(list)
    for r in rows:
        by_instance[r.instance].append(r)
    out = []
    for segs in by_instance.values():
        segs.sort(key=lambda r: r.seq)
        if ([r.seq for r in segs] == list(range(n))
                and run.t0 <= segs[-1].end <= run.t1):
            out.append(segs)
    return out


def median_ms(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    return 1e3 * statistics.median(values) if values else None


def layer_launch_ms(run, role: str) -> Optional[float]:
    """Median of ``issued - start`` over ``role``'s ``layer`` segments
    that started in the window."""
    rows = window(run, role)
    if rows is None:
        return None
    return median_ms(r.issued - r.start for r in rows
                     if r.kernel.endswith("/layer"))


def overlap(xs: List[Interval], ys: List[Interval]) -> float:
    """The length of the intersection of two sorted, disjoint lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(run) -> List[Interval]:
    """The window's device-idle intervals: between the trace's busy ones."""
    out, at = [], run.t0
    for a, b in run.trace.busy():
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if run.t1 > at:
        out.append((at, run.t1))
    return out


def idle_share(run, first: str, last: str) -> Optional[float]:
    """Per cent of the window's device-idle time that lies inside some
    window row's [``first``, ``last``] stamps."""
    if run.trace is None or not run.trace.ops:
        return None
    rows = window(run)
    if not rows:
        return None
    gaps = idle(run)
    total = sum(b - a for a, b in gaps)
    if total <= 0:
        return None
    # the union of the rows' intervals within the window, as the trace
    # merges device operations
    inside = Trace(run.t0, run.t1, [(first, getattr(r, first),
                                     getattr(r, last)) for r in rows]).busy()
    return 100.0 * overlap(gaps, inside) / total
