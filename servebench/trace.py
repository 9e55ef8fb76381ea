"""The traced run's reading of the device: ``torch.profiler`` over the
window, its CUDA activity put on the host's clock, and the benchmark's
own spans (one per segment call and per host step between segments,
logged by ``harness.Served``) laid over it.

Only device activity is recorded: recording every operator of every
host thread as well slowed the host-bound serving path severalfold on
the card. The profiler starts before the window opens and stops after it
closes, since starting and stopping it stall the host; it is stopped at
its lowest level (``_disable_profiler``) and only its raw events are
read, since the profiler objects of some releases build a Python event
tree on stopping, tens of seconds for a window. It stamps events on the
wall clock (``time.time_ns``), joined to ``time.perf_counter_ns`` by
reading both at the window's ends.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType, _disable_profiler
from torch.autograd.profiler import profile

#: entries of each breakdown list, and the longest kernel name kept
TOP = 10
NAME_CHARS = 120


@dataclass
class Trace:
    """Device operations [(name, start_s, end_s)] on the perf_counter clock
    within the traced window [t0, t1]."""
    t0: float
    t1: float
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    _busy: Optional[List[Tuple[float, float]]] = field(default=None,
                                                       repr=False)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window, in time order."""
        if self._busy is not None:
            return self._busy
        out: List[List[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        self._busy = [(a, b) for a, b in out]
        return self._busy

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def device_ops(self) -> List[List]:
        """The device operations that took most time: [[name, seconds]]."""
        total: Dict[str, float] = defaultdict(float)
        for name, a, b in self.ops:
            total[name[:NAME_CHARS]] += b - a
        return [[n, s] for n, s in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self, spans: List[Tuple[str, float, float]]) -> List[List]:
        """Idle time of the device by what the host was doing: each gap
        between busy intervals goes to the span that covers most of it
        ("engine" where no segment or host step of the benchmark's spans
        ran: scheduling, queues, the admission plane)."""
        busy = self.busy()
        gaps, at = [], self.t0
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = b
        if self.t1 > at:
            gaps.append((at, self.t1))
        spans = sorted(s for s in spans if s[2] > self.t0 and s[1] < self.t1)
        starts = [s[1] for s in spans]
        total: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            cover: Dict[str, float] = defaultdict(float)
            i = max(0, bisect.bisect_right(starts, a) - 1)
            while i < len(spans) and spans[i][1] < b:
                o = min(b, spans[i][2]) - max(a, spans[i][1])
                if o > 0:
                    cover[spans[i][0]] += o
                i += 1
            who = max(cover, key=cover.get) if cover else "engine"
            total[who] += b - a
        return [[n, s] for n, s in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:TOP]]

    def owner(self, spans: List[Tuple[str, float, float]]):
        """``owner(start)``: the span (name) during which a device
        operation starting at ``start`` ran, or None. Segments end in a
        device synchronisation, so an operation runs inside the span of
        the segment that launched it."""
        spans = sorted(spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]

        def find(t: float) -> Optional[str]:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][2] >= t:
                return spans[i][0]
            return None
        return find


def _wall_minus_perf_ns() -> int:
    return time.time_ns() - time.perf_counter_ns()


class Tracer:
    """Profiles the device from ``start()`` to ``stop(t0, t1)``, which
    keeps what ran in the window [t0, t1] (perf_counter seconds)."""

    def __init__(self):
        self._prof = None

    def start(self) -> None:
        cuda = torch.cuda.is_available()
        self._prof = profile(use_cpu=not cuda, use_kineto=True,
                             use_device="cuda" if cuda else None)
        self._prof.__enter__()
        self._shift = _wall_minus_perf_ns()

    def stop(self, t0: float, t1: float) -> Trace:
        shift = (self._shift + _wall_minus_perf_ns()) // 2
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        events = _disable_profiler().events()
        self._prof = None
        ops = [(e.name(), (e.start_ns() - shift) * 1e-9,
                (e.start_ns() + e.duration_ns() - shift) * 1e-9)
               for e in events if e.device_type() == DeviceType.CUDA]
        return Trace(t0, t1, ops)
