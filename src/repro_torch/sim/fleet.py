"""Sharded fleet simulation behind the placement seam.

A K-device ``SimScheduler`` with a *static* placement discipline and
work-stealing off is embarrassingly parallel: once each task's device is
known up front, the fleet factorises into K independent single-device
simulations — no event on one device can influence another (no steal
migration, no cross-device load state, and the per-device decision
sequence is a function of that device's task subset alone). This module
exploits that: :func:`elect_devices` reproduces the monolithic layer's
election statically, :func:`simulate_fleet` runs one K=1 subsimulation
per device (optionally across process workers) and merges the results
into a single ``SimReport`` whose decision traces are **identical** to
the monolithic run after remapping shard-local instance ids to global
ones (pinned by ``tests/test_sim_fastcore.py``).

**No-coupling rule** (the module's one load-bearing assumption): a
shard may depend on nothing outside its own task subset. Any feature
that lets one device's events influence another — dynamic election,
steal migration, a shared RNG stream, a shared mutable collaborator —
is coupling, and coupled configurations must be **rejected eagerly**
(raise at ``simulate_fleet`` entry), never sharded approximately. The
concrete rejections below are instances of this rule; when extending
the fleet runner, add the check rather than weakening the guarantee.

Equivalence contract — the sharded run matches the monolithic K-device
run bit-for-bit only when:

- the discipline is static (``round_robin`` / ``priority_affinity`` / a
  ``fn(index, spec, devices)`` callable) — ``least_loaded`` consults
  global load and is rejected;
- ``steal=False`` (migration couples devices);
- ``jitter == 0`` — with noise the monolithic run interleaves one RNG
  stream across devices while shards each draw their own;
- shared mutable collaborators (``online=``, ``interference=``,
  ``jobstore=``) are absent — each shard would otherwise need its own.

Outside that envelope, run the monolithic ``SimScheduler`` instead; the
fleet runner raises rather than silently diverging.
"""
from __future__ import annotations

import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple, Union

from repro_torch.core.policy import Mode
from repro_torch.core.scheduler import KernelExec, SimReport, SimScheduler
from repro_torch.core.task import NUM_PRIORITIES, TaskSpec

__all__ = ["elect_devices", "simulate_fleet", "FleetResult",
           "STATIC_DISCIPLINES"]

#: Disciplines whose election is a pure function of (arrival order,
#: priority) — reproducible without running the simulation.
STATIC_DISCIPLINES: Tuple[str, ...] = ("round_robin", "priority_affinity")

StaticDiscipline = Union[str, Callable[[int, TaskSpec, int], int]]


def elect_devices(tasks: Sequence[TaskSpec], devices: int,
                  discipline: StaticDiscipline = "round_robin"
                  ) -> List[int]:
    """Statically reproduce ``PlacementLayer`` election for each task.

    ``round_robin`` rotates in arrival-event order — the order the
    simulator's event heap delivers ``task_begin`` calls: ascending
    ``(arrival, submission index)``. ``priority_affinity`` is stateless
    (``priority * K // NUM_PRIORITIES``). A callable gets
    ``(index, spec, devices)`` and must return a device in range.
    """
    if devices <= 0:
        raise ValueError(f"need devices >= 1, got {devices}")
    n = len(tasks)
    out = [0] * n
    if callable(discipline):
        for i, t in enumerate(tasks):
            d = discipline(i, t, devices)
            if not 0 <= d < devices:
                raise ValueError(f"custom discipline placed task {i} on "
                                 f"device {d} of {devices}")
            out[i] = d
    elif discipline == "round_robin":
        order = sorted(range(n), key=lambda i: (tasks[i].arrival, i))
        for pos, i in enumerate(order):
            out[i] = pos % devices
    elif discipline == "priority_affinity":
        for i, t in enumerate(tasks):
            out[i] = t.priority * devices // NUM_PRIORITIES
    else:
        raise ValueError(
            f"discipline {discipline!r} is not statically electable "
            f"(static: {STATIC_DISCIPLINES} or a callable); use the "
            f"monolithic SimScheduler for dynamic disciplines")
    return out


@dataclass
class FleetResult:
    """Merged outcome of a sharded fleet run.

    ``report`` mirrors the monolithic K-device ``SimReport``: global
    task order, summed counters, per-device ``busy`` accumulators.
    ``traces[d]`` is device ``d``'s decision trace with instance ids
    remapped to global task indices; ``device_of[i]`` is task ``i``'s
    elected device; ``shards[d]`` lists the global indices simulated on
    device ``d``. ``wall_s`` is the end-to-end wall-clock cost
    (including election, sharding and merging).
    """
    report: SimReport
    device_of: List[int]
    shards: List[List[int]]
    traces: List[list] = field(default_factory=list)
    wall_s: float = 0.0


def _remap_trace(trace: Sequence[tuple], to_global: Sequence[int]) -> list:
    """Rewrite shard-local instance ids (tuple index 1; ``holder`` may
    carry None) to global task indices."""
    out = []
    for ev in trace:
        inst = ev[1]
        out.append((ev[0],
                    inst if inst is None else to_global[inst]) + ev[2:])
    return out


def _run_shard(payload):
    tasks, mode, kwargs = payload
    sim = SimScheduler(tasks, mode, devices=1, **kwargs)
    report = sim.run()
    return report, list(sim.placement.policies[0].trace)


def simulate_fleet(tasks: Sequence[TaskSpec], mode: Mode, *,
                   devices: int,
                   discipline: StaticDiscipline = "round_robin",
                   workers: int = 1,
                   trace: str = "off",
                   record_timeline: bool = False,
                   **sim_kwargs) -> FleetResult:
    """Run ``tasks`` over a ``devices``-GPU fleet as sharded K=1 sims.

    ``workers > 1`` fans the shards across a process pool (shards and
    reports pickle cleanly; ``KernelID`` interning survives the round
    trip). Remaining ``sim_kwargs`` forward to each ``SimScheduler``
    (``profiled=``, ``queue_discipline=``, ``pipeline_depth=``, ...);
    kwargs that break the sharding equivalence contract are rejected.
    Defaults favour scale: traces and timelines off.
    """
    for bad in ("devices", "steal", "jobstore", "fault_plan", "online",
                "interference", "jitter"):
        if sim_kwargs.get(bad):
            raise ValueError(f"simulate_fleet does not support {bad}= "
                             f"(breaks the sharding equivalence contract)")
        sim_kwargs.pop(bad, None)
    t0 = time.perf_counter()
    device_of = elect_devices(tasks, devices, discipline)
    shards: List[List[int]] = [[] for _ in range(devices)]
    for i, d in enumerate(device_of):
        shards[d].append(i)
    kwargs = dict(sim_kwargs, trace=trace, record_timeline=record_timeline)
    payloads = [([tasks[i] for i in shard], mode, kwargs)
                for shard in shards]
    if workers > 1:
        with ProcessPoolExecutor(max_workers=workers) as pool:
            outs = list(pool.map(_run_shard, payloads, chunksize=1))
    else:
        outs = [_run_shard(p) for p in payloads]

    results = [None] * len(tasks)
    timeline: list = []
    traces: List[list] = []
    busy = [0.0] * devices
    fills = steals = misses = tagged = events = 0
    overshoot = 0.0
    for d, (rep, tr) in enumerate(outs):
        shard = shards[d]
        for li, r in enumerate(rep.results):
            results[shard[li]] = r
        for k in rep.timeline:
            # relabel the shard's device 0 as fleet device d and its
            # local task ids as global indices
            timeline.append(KernelExec(task=shard[k.task], seq=k.seq,
                                       start=k.start, end=k.end,
                                       filler=k.filler, device=d))
        traces.append(_remap_trace(tr, shard))
        busy[d] = (rep.busy[0] if rep.busy else rep.device_busy())
        fills += rep.fills
        steals += rep.steals
        misses += rep.deadline_misses
        tagged += rep.deadlines_tagged
        events += rep.events
        overshoot += rep.overshoot_time
    timeline.sort(key=lambda k: (k.start, k.device))
    report = SimReport(results=results, timeline=timeline, fills=fills,
                       overshoot_time=overshoot, devices=devices,
                       steals=steals, deadline_misses=misses,
                       deadlines_tagged=tagged, events=events, busy=busy)
    return FleetResult(report=report, device_of=device_of, shards=shards,
                       traces=traces, wall_s=time.perf_counter() - t0)
