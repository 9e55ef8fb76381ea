"""Open-loop traffic generation + replay against the admission plane.

Open-loop means arrivals follow a pre-drawn schedule and NEVER wait for
completions — the serving-under-overload regime the closed-loop
``invoke_concurrent`` path cannot produce (a blocked client is implicit
backpressure). The generator draws Poisson processes, optionally
modulated by a diurnal rate curve (thinning), and the replayer feeds
the merged schedule to ``AdmissionPlane.submit`` from one feeder
thread, honoring inter-arrival times at a configurable speedup.

Used by ``benchmarks/bench_serving_load.py`` (≥10⁵ requests full scale)
and the ``repro_torch.launch.serve load`` CLI verb.
"""
from __future__ import annotations

import math
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

__all__ = ["Arrival", "poisson_arrivals", "diurnal_arrivals",
           "merge_schedules", "replay"]


@dataclass(frozen=True)
class Arrival:
    """One scheduled submit: time (s, schedule-relative), service, QoS
    class name, and an optional per-request relative deadline override."""
    t: float
    service: object
    qos: str
    deadline: object = None     # None = class default; use _UNSET semantics


def poisson_arrivals(rate: float, duration: float, service, qos: str,
                     rng: random.Random,
                     deadline=None) -> List[Arrival]:
    """Homogeneous Poisson arrivals at ``rate`` req/s over ``duration``
    seconds (exponential inter-arrival gaps)."""
    out: List[Arrival] = []
    t = rng.expovariate(rate) if rate > 0 else float("inf")
    while t < duration:
        out.append(Arrival(t, service, qos, deadline))
        t += rng.expovariate(rate)
    return out


def diurnal_arrivals(base_rate: float, duration: float, service, qos: str,
                     rng: random.Random, period: Optional[float] = None,
                     depth: float = 0.5, deadline=None) -> List[Arrival]:
    """Non-homogeneous Poisson arrivals with a sinusoidal "diurnal" rate
    ``base_rate * (1 + depth*sin(2πt/period))``, drawn by thinning
    against the peak rate. ``period`` defaults to the full duration (one
    day == one replay window); ``depth`` in [0, 1)."""
    if not 0 <= depth < 1:
        raise ValueError(f"diurnal depth must be in [0, 1), got {depth}")
    period = duration if period is None else period
    peak = base_rate * (1 + depth)
    out: List[Arrival] = []
    t = rng.expovariate(peak) if peak > 0 else float("inf")
    while t < duration:
        rate_t = base_rate * (1 + depth * math.sin(2 * math.pi * t / period))
        if rng.random() < rate_t / peak:       # thinning acceptance
            out.append(Arrival(t, service, qos, deadline))
        t += rng.expovariate(peak)
    return out


def merge_schedules(*schedules: Sequence[Arrival]) -> List[Arrival]:
    """Merge per-class schedules into one time-ordered replay tape."""
    merged: List[Arrival] = []
    for s in schedules:
        merged.extend(s)
    merged.sort(key=lambda a: a.t)
    return merged


@dataclass
class ReplayReport:
    offered: int = 0
    wall_s: float = 0.0
    schedule_s: float = 0.0
    tickets: List[object] = field(default_factory=list)
    lag_max_s: float = 0.0      # worst feeder lateness vs the schedule


def replay(plane, schedule: Sequence[Arrival], speed: float = 1.0,
           keep_tickets: bool = True,
           on_submit: Optional[Callable] = None) -> ReplayReport:
    """Feed ``schedule`` to ``plane.submit`` open-loop: each arrival is
    submitted at its scheduled time (compressed by ``speed``; 2.0 =
    twice as fast) regardless of what completed — exactly the sustained
    traffic an admission plane exists to absorb. Returns a report with
    the tickets (unless ``keep_tickets=False``; ``on_submit(arrival,
    ticket)`` still sees each one, e.g. to count outcomes online).

    The feeder catches up bursts without sleeping between already-due
    arrivals, and records its worst lateness so a bench can reject a
    replay whose feeder (not the plane) was the bottleneck."""
    rep = ReplayReport(schedule_s=(schedule[-1].t if schedule else 0.0))
    t0 = time.perf_counter()
    for a in schedule:
        due = t0 + a.t / speed
        now = time.perf_counter()
        if due > now:
            time.sleep(due - now)
        else:
            rep.lag_max_s = max(rep.lag_max_s, now - due)
        ticket = plane.submit(a.service, a.qos) if a.deadline is None \
            else plane.submit(a.service, a.qos, deadline=a.deadline)
        rep.offered += 1
        if keep_tickets:
            rep.tickets.append(ticket)
        if on_submit is not None:
            on_submit(a, ticket)
    rep.wall_s = time.perf_counter() - t0
    return rep


def wait_all(tickets: Sequence, timeout: float = 60.0) -> bool:
    """Wait until every ticket resolved; True if all made it in time."""
    deadline = time.monotonic() + timeout
    for t in tickets:
        left = deadline - time.monotonic()
        if left <= 0 or t.result(timeout=left) is None:
            return False
    return True


def feeder_thread(plane, schedule, speed: float = 1.0,
                  on_submit: Optional[Callable] = None
                  ) -> Tuple[threading.Thread, ReplayReport]:
    """Run ``replay`` on a background thread (the CLI's live mode);
    returns (started thread, report being filled in)."""
    rep = ReplayReport(schedule_s=(schedule[-1].t if schedule else 0.0))

    def _run():
        r = replay(plane, schedule, speed=speed, keep_tickets=True,
                   on_submit=on_submit)
        rep.offered, rep.wall_s = r.offered, r.wall_s
        rep.tickets, rep.lag_max_s = r.tickets, r.lag_max_s

    th = threading.Thread(target=_run, daemon=True, name="fikit-loadgen")
    th.start()
    return th, rep
