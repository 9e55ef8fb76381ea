"""Synthetic workload generation for cluster-scale simulation.

Real-time GPU scheduling work evaluates on periodic/sporadic task sets
sampled by total utilization (UUNIFAST, Bini & Buttazzo 2005); serving
work is judged on load-vs-latency curves over tenant classes driven by
arrival traces. This module produces both, deterministically by seed:

- :func:`uunifast` / :func:`uunifast_discard`: per-task utilization
  sampling summing exactly to a target, each share in ``(0, 1]``.
- :func:`periodic_taskset`: a :class:`TaskSet` of :class:`PeriodicTask`
  records — period drawn from an integer-millisecond grid (so the
  hyperperiod stays a small exact ``lcm``), WCET = u * period split into
  a kernel trace by a :class:`KernelShape`, priority assigned by bands.
- :func:`release_jobs`: expand a task set over a horizon (default one
  hyperperiod) into arrival-sorted ``TaskSpec`` job instances; periodic
  releases at ``phase + k * period``, or sporadic releases whose
  inter-arrival times are ``>= period`` (period = minimum separation).
- :func:`specs_from_arrivals` (+ :func:`poisson_trace` /
  :func:`diurnal_trace`): adapt ``serving/loadgen.py``'s seeded Poisson
  and diurnal schedules into ``TaskSpec`` lists for the simulator.

Every job instance of a task shares the task's (immutable) kernel list,
so a million-request trace does not materialise a million kernel lists.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple, Union

from repro_torch.core.kernel_id import KernelID
from repro_torch.core.task import NUM_PRIORITIES, TaskKey, TaskSpec, TraceKernel
from repro_torch.serving.loadgen import (Arrival, diurnal_arrivals,
                                   poisson_arrivals)

__all__ = [
    "uunifast", "uunifast_discard", "hyperperiod_ms",
    "KernelShape", "DEFAULT_SHAPES", "shape_from_profile",
    "PeriodicTask", "TaskSet", "periodic_taskset", "release_jobs",
    "specs_from_arrivals", "poisson_trace", "diurnal_trace",
    "DEFAULT_PERIODS_MS", "DEFAULT_PRIORITY_BANDS",
]

#: Period grid (integer milliseconds). Chosen so the lcm over any subset
#: is at most 2000 ms — hyperperiod sweeps stay short and exact.
DEFAULT_PERIODS_MS: Tuple[int, ...] = (10, 20, 40, 50, 100, 200, 250, 500,
                                       1000)

#: (priority, weight) bands: the first ~20% of tasks are hi-priority
#: interactive tenants (Q0), the next 30% mid (Q4), the rest batch (Q8).
DEFAULT_PRIORITY_BANDS: Tuple[Tuple[int, float], ...] = ((0, 0.2), (4, 0.3),
                                                         (8, 0.5))


def _as_rng(seed_or_rng: Union[int, random.Random]) -> random.Random:
    if isinstance(seed_or_rng, random.Random):
        return seed_or_rng
    return random.Random(seed_or_rng)


def uunifast(n: int, total_util: float,
             seed_or_rng: Union[int, random.Random]) -> List[float]:
    """UUNIFAST: ``n`` utilizations summing to ``total_util``, uniformly
    distributed over the valid simplex. Individual shares may exceed 1
    when ``total_util > 1``; use :func:`uunifast_discard` to bound them.
    """
    if n <= 0:
        raise ValueError(f"need n >= 1 tasks, got {n}")
    if total_util <= 0:
        raise ValueError(f"need total_util > 0, got {total_util}")
    rng = _as_rng(seed_or_rng)
    utils: List[float] = []
    remaining = float(total_util)
    for i in range(n - 1, 0, -1):
        nxt = remaining * rng.random() ** (1.0 / i)
        utils.append(remaining - nxt)
        remaining = nxt
    utils.append(remaining)
    return utils


def _clamp_redistribute(utils: List[float]) -> List[float]:
    """Clamp shares above 1 to 1 and hand their excess to the others
    proportionally to remaining headroom. Feasible whenever
    ``sum(utils) <= n``; one proportional pass keeps every share <= 1
    (each receives at most its own headroom), iterated defensively for
    float rounding."""
    utils = list(utils)
    for _ in range(len(utils)):
        excess = 0.0
        free: List[int] = []
        for i, u in enumerate(utils):
            if u > 1.0:
                excess += u - 1.0
                utils[i] = 1.0
            elif u < 1.0:
                free.append(i)
        if excess <= 0.0 or not free:
            break
        headroom = sum(1.0 - utils[i] for i in free)
        for i in free:
            utils[i] += excess * (1.0 - utils[i]) / headroom
    return utils


def uunifast_discard(n: int, total_util: float,
                     seed_or_rng: Union[int, random.Random],
                     max_tries: int = 50) -> List[float]:
    """UUNIFAST with discard-resampling: every share lies in ``(0, 1]``.

    Requires ``total_util <= n`` (otherwise no valid assignment exists).
    Resamples whole vectors until one qualifies. Near saturation
    (``total_util`` -> ``n``) the accept probability of a raw UUNIFAST
    draw collapses — P(max Dirichlet spacing <= 1/U) is astronomically
    small already at ``U ~ 0.8 n`` for moderate ``n`` — so after
    ``max_tries`` discards the last draw is repaired deterministically
    by clamp-and-redistribute (slightly biased toward uniform shares,
    exactly feasible, still a pure function of the seed).
    """
    if total_util > n:
        raise ValueError(f"total_util {total_util} infeasible for {n} tasks")
    rng = _as_rng(seed_or_rng)
    utils: List[float] = []
    for _ in range(max_tries):
        utils = uunifast(n, total_util, rng)
        if all(0.0 < u <= 1.0 for u in utils):
            return utils
    return _clamp_redistribute(utils)


def hyperperiod_ms(periods_ms: Sequence[int]) -> int:
    """Exact hyperperiod (lcm) of integer-millisecond periods."""
    if not periods_ms:
        return 0
    h = 1
    for p in periods_ms:
        if int(p) != p or p <= 0:
            raise ValueError(f"periods must be positive integers (ms): {p}")
        h = math.lcm(h, int(p))
    return h


@dataclass(frozen=True)
class KernelShape:
    """How a task's WCET is split into a kernel trace.

    ``n_kernels`` kernels whose durations are drawn with multiplicative
    spread ``+-spread`` around equal shares (then renormalised so the
    kernel durations sum exactly to the compute budget); each kernel is
    followed by a host gap of ``gap_fraction`` of its duration (the last
    gap does not count toward solo JCT). ``max_inflight`` models the
    client: 1 = synchronous, >1 = CUDA-style async launch-ahead.
    """
    name: str
    n_kernels: int
    gap_fraction: float = 0.1
    spread: float = 0.5
    max_inflight: int = 1
    kclass_cycle: Tuple[Optional[str], ...] = (None,)

    def synthesize(self, wcet_s: float,
                   rng: random.Random) -> List[TraceKernel]:
        """Split ``wcet_s`` of solo JCT into a deterministic kernel list."""
        n = self.n_kernels
        if n <= 0:
            raise ValueError(f"shape {self.name}: need n_kernels >= 1")
        weights = [rng.uniform(1.0 - self.spread, 1.0 + self.spread)
                   for _ in range(n)]
        # solo JCT = sum(dur_i * (1 + gap_fraction)) - last gap
        budget = wcet_s / (1.0 + self.gap_fraction
                           - self.gap_fraction * weights[-1] / sum(weights))
        scale = budget / sum(weights)
        out: List[TraceKernel] = []
        for i, w in enumerate(weights):
            dur = w * scale
            out.append(TraceKernel(
                kid=KernelID(f"{self.name}_k{i}", grid=(n,), block=(i,)),
                duration=dur,
                gap_after=dur * self.gap_fraction,
                kclass=self.kclass_cycle[i % len(self.kclass_cycle)]))
        return out


#: Shapes mirroring the profiled model families used by the benchmarks:
#: short interactive decode steps vs. long memory-heavy batch pipelines.
DEFAULT_SHAPES: Tuple[KernelShape, ...] = (
    KernelShape("interactive", n_kernels=6, gap_fraction=0.15, spread=0.4,
                max_inflight=1,
                kclass_cycle=("compute", "compute", "memory")),
    KernelShape("batch", n_kernels=12, gap_fraction=0.05, spread=0.6,
                max_inflight=4,
                kclass_cycle=("memory", "compute")),
)


def shape_from_profile(profile, name: Optional[str] = None,
                       max_inflight: int = 1) -> KernelShape:
    """Derive a :class:`KernelShape` from a profiled ``TaskProfile``
    (its SK/SG tables): kernel count, mean gap/duration ratio and the
    empirical duration spread, so synthetic fleets inherit the shape of
    real measured models."""
    if not profile.SK:
        raise ValueError("profile has no SK entries")
    durs = list(profile.SK.values())
    gaps = [profile.SG.get(k, 0.0) for k in profile.SK]
    mean = sum(durs) / len(durs)
    spread = min(0.95, (max(durs) - min(durs)) / (2.0 * mean)) if mean else 0.0
    gap_fraction = (sum(gaps) / sum(durs)) if sum(durs) else 0.0
    return KernelShape(name=name or profile.key.process,
                       n_kernels=len(durs), gap_fraction=gap_fraction,
                       spread=spread, max_inflight=max_inflight)


@dataclass(frozen=True)
class PeriodicTask:
    """One recurring task of a synthetic task set."""
    index: int
    key: TaskKey
    priority: int
    utilization: float
    period_ms: int
    phase_s: float
    wcet_s: float
    kernels: Tuple[TraceKernel, ...]
    max_inflight: int = 1
    #: relative deadline (seconds after each release); implicit = period.
    rel_deadline_s: float = 0.0

    @property
    def period_s(self) -> float:
        return self.period_ms / 1000.0


@dataclass(frozen=True)
class TaskSet:
    """A sampled task set plus the parameters that reproduce it."""
    tasks: Tuple[PeriodicTask, ...]
    total_util: float
    seed: int

    @property
    def hyperperiod_ms(self) -> int:
        return hyperperiod_ms([t.period_ms for t in self.tasks])

    @property
    def hyperperiod_s(self) -> float:
        return self.hyperperiod_ms / 1000.0

    def utilization(self) -> float:
        return sum(t.utilization for t in self.tasks)


def _band_priority(i: int, n: int,
                   bands: Sequence[Tuple[int, float]]) -> int:
    """Deterministic band assignment by index proportion: the first
    ``weight`` fraction of tasks gets the first band's priority, etc."""
    total = sum(w for _, w in bands)
    frac = (i + 0.5) / n
    cum = 0.0
    for prio, w in bands:
        cum += w / total
        if frac <= cum:
            return prio
    return bands[-1][0]


def periodic_taskset(n: int, total_util: float, seed: int, *,
                     periods_ms: Sequence[int] = DEFAULT_PERIODS_MS,
                     priority_bands: Sequence[Tuple[int, float]]
                     = DEFAULT_PRIORITY_BANDS,
                     shapes: Sequence[KernelShape] = DEFAULT_SHAPES,
                     phase_jitter: float = 0.0,
                     name: str = "synth") -> TaskSet:
    """Sample a periodic task set: UUNIFAST utilizations, log-uniform
    period from the integer grid, WCET = u * period synthesised into a
    kernel trace by an alternating shape, priority by index bands.
    Fully deterministic given ``seed``."""
    rng = random.Random(seed)
    utils = uunifast_discard(n, total_util, rng)
    for prio, _ in priority_bands:
        if not 0 <= prio < NUM_PRIORITIES:
            raise ValueError(f"band priority {prio} out of range")
    log_periods = sorted(periods_ms)
    tasks: List[PeriodicTask] = []
    for i, u in enumerate(utils):
        # log-uniform pick over the grid biases toward shorter periods,
        # matching interactive-heavy tenant mixes.
        pick = int(len(log_periods) * rng.random() ** 1.5)
        period_ms = log_periods[min(pick, len(log_periods) - 1)]
        wcet_s = u * period_ms / 1000.0
        shape = shapes[i % len(shapes)]
        kernels = tuple(shape.synthesize(wcet_s, rng))
        phase = rng.uniform(0.0, phase_jitter * period_ms / 1000.0)
        tasks.append(PeriodicTask(
            index=i,
            key=TaskKey(f"{name}_{shape.name}", args=(i,)),
            priority=_band_priority(i, n, priority_bands),
            utilization=u, period_ms=period_ms, phase_s=phase,
            wcet_s=wcet_s, kernels=kernels,
            max_inflight=shape.max_inflight,
            rel_deadline_s=period_ms / 1000.0))
    return TaskSet(tasks=tuple(tasks), total_util=total_util, seed=seed)


def release_jobs(taskset: TaskSet, *, cycles: int = 1,
                 horizon_s: Optional[float] = None, sporadic: bool = False,
                 sporadic_slack: float = 0.5,
                 seed: Optional[int] = None,
                 tag_deadlines: bool = True) -> List[TaskSpec]:
    """Expand a task set into arrival-sorted ``TaskSpec`` job instances.

    Horizon defaults to ``cycles`` hyperperiods. Periodic tasks release
    at ``phase + k * period``; with ``sporadic=True`` the period becomes
    the *minimum* inter-arrival time and each successive gap is
    ``period + Exp(mean = sporadic_slack * period)`` (seeded by ``seed``,
    default the task set's own seed). Deadlines are absolute
    (``release + rel_deadline``) when ``tag_deadlines``.
    """
    if horizon_s is None:
        horizon_s = taskset.hyperperiod_s * cycles
    rng = random.Random(taskset.seed if seed is None else seed)
    jobs: List[TaskSpec] = []
    for t in taskset.tasks:
        kernels = list(t.kernels)  # one shared list per task, not per job
        rel = t.rel_deadline_s if tag_deadlines else None
        arr = t.phase_s
        while arr < horizon_s:
            jobs.append(TaskSpec(
                key=t.key, priority=t.priority, kernels=kernels,
                arrival=arr, max_inflight=t.max_inflight,
                deadline=(arr + rel) if rel is not None else None))
            if sporadic:
                arr += t.period_s + rng.expovariate(
                    1.0 / (sporadic_slack * t.period_s))
            else:
                arr += t.period_s
    jobs.sort(key=lambda s: s.arrival)
    return jobs


# ---------------------------------------------------------------------------
# Arrival-trace synthesis (reuses serving/loadgen schedules)
# ---------------------------------------------------------------------------

def specs_from_arrivals(schedule: Sequence[Arrival],
                        template_of: Optional[Callable[[Arrival],
                                                       TaskSpec]] = None
                        ) -> List[TaskSpec]:
    """Turn a loadgen schedule into simulator jobs.

    Each ``Arrival.service`` must be a ``TaskSpec`` template (or
    ``template_of(arrival)`` must produce one). The template's kernels
    are shared across instances; ``Arrival.deadline`` — a *relative*
    per-request override in loadgen — becomes an absolute sim deadline.
    """
    out: List[TaskSpec] = []
    for a in sorted(schedule, key=lambda a: a.t):
        tpl = template_of(a) if template_of is not None else a.service
        if not isinstance(tpl, TaskSpec):
            raise TypeError(f"arrival service is not a TaskSpec: {tpl!r}")
        if a.deadline is not None:
            deadline = a.t + a.deadline
        elif tpl.deadline is not None:
            deadline = a.t + tpl.deadline
        else:
            deadline = None
        out.append(TaskSpec(key=tpl.key, priority=tpl.priority,
                            kernels=tpl.kernels, arrival=a.t,
                            max_inflight=tpl.max_inflight,
                            deadline=deadline))
    return out


def poisson_trace(template: TaskSpec, rate: float, duration: float,
                  seed: int, deadline: Optional[float] = None,
                  qos: str = "default") -> List[TaskSpec]:
    """Seeded homogeneous-Poisson job trace for one service template."""
    sched = poisson_arrivals(rate, duration, template, qos,
                             random.Random(seed), deadline=deadline)
    return specs_from_arrivals(sched)


def diurnal_trace(template: TaskSpec, base_rate: float, duration: float,
                  seed: int, period: Optional[float] = None,
                  depth: float = 0.5, deadline: Optional[float] = None,
                  qos: str = "default") -> List[TaskSpec]:
    """Seeded diurnal (thinned non-homogeneous Poisson) job trace."""
    sched = diurnal_arrivals(base_rate, duration, template, qos,
                             random.Random(seed), period=period,
                             depth=depth, deadline=deadline)
    return specs_from_arrivals(sched)
