"""FIKIT scheduler over a serial device — discrete-event simulator.

Models the paper's system (Figs 7, 8, 11, 12):

- Each *client* (one per task) issues kernel launches on its own host
  timeline. A synchronous client (``max_inflight=1``) issues kernel i+1
  only after observing kernel i's completion plus a host gap — this creates
  the inter-kernel device idle ("gap") FIKIT scavenges. An async client
  (``max_inflight=m>1``) issues launch i+1 a host-gap after launch i with
  up to m kernels in flight — the CUDA-stream behavior that lets a
  device-bound low-priority task flood the FIFO device queue and inflate a
  high-priority co-tenant's JCT in default sharing mode (Fig 2 "Sharing 1").
- Each *device* executes launched kernels serially in launch (FIFO) order.
  Kernels are non-preemptible. ``devices=K`` models a K-device node: one
  independent serial timeline per device.
- Modes (see ``repro_torch.core.policy.Mode``): EXCLUSIVE, SHARING, FIKIT, and
  PREEMPT (kernel-boundary preemptive sharing).

ALL scheduling decisions — holder election, routing, gap open/close with
feedback, the bounded fill loop, release-on-task-done, overshoot — live in
``repro_torch.core.policy.FikitPolicy``; device election and cross-device work
stealing live in ``repro_torch.core.placement.PlacementLayer``, which owns one
policy per device (K=1 is a pinned-identical pass-through). This module is
a thin driver: it owns the event heap, the client issue model, and the
virtual device timelines, and hands every decision to the shared
placement/policy stack so the simulator and the wall-clock engine can
never diverge.

Determinism: the event heap is ordered by (time, seq); ties resolve by
insertion order, so simulations are exactly reproducible.
"""
from __future__ import annotations

import heapq
import itertools
import random as _random
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core import jobstore as _js
from repro_torch.core.fikit import EPSILON
from repro_torch.core.interference import COMPUTE_BOUND, InterferenceModel
from repro_torch.core.jobstore import coerce_store, spec_to_obj
from repro_torch.core.online import OnlineConfig, OnlineMeasurement
from repro_torch.core.placement import DisciplineSpec, PlacementLayer
from repro_torch.core.policy import Mode
from repro_torch.core.profiler import ProfiledData, Profiler
from repro_torch.core.task import KernelRequest, TaskSpec

__all__ = ["Mode", "KernelExec", "TaskResult", "SimReport", "SimScheduler",
           "OnlineConfig", "measure_task", "profile_tasks"]


@dataclass
class KernelExec:
    """One executed kernel interval on a device timeline."""
    task: int
    seq: int
    start: float
    end: float
    filler: bool = False
    device: int = 0


@dataclass
class TaskResult:
    arrival: float
    start: float = -1.0
    completion: float = -1.0

    @property
    def jct(self) -> float:
        return self.completion - self.arrival


@dataclass
class SimReport:
    results: List[TaskResult]
    timeline: List[KernelExec]
    fills: int = 0
    overshoot_time: float = 0.0   # filler time past actual gap end ("ovh 2")
    devices: int = 1
    steals: int = 0
    #: deadline-tagged tasks that completed after their deadline / that
    #: carried one at all (EDF instrumentation; 0/0 without deadlines)
    deadline_misses: int = 0
    deadlines_tagged: int = 0
    #: ``OnlineMeasurement.stats()`` snapshot (observation/commit/drift
    #: counters) when the run had the online loop enabled; None otherwise
    online_stats: Optional[dict] = None
    #: total simulator events processed (arrival/issue/kernel_end) — the
    #: numerator of the fleet benchmark's events/sec throughput metric
    events: int = 0
    #: per-device busy-time accumulators, kept even when the per-kernel
    #: ``timeline`` is not recorded (``SimScheduler(record_timeline=
    #: False)``) so utilization analytics survive fleet-scale runs
    busy: Optional[List[float]] = None

    def jct(self, i: int) -> float:
        return self.results[i].jct

    @property
    def deadline_miss_rate(self) -> float:
        """Fraction of deadline-tagged tasks that missed (0.0 if none)."""
        if self.deadlines_tagged == 0:
            return 0.0
        return self.deadline_misses / self.deadlines_tagged

    @property
    def makespan(self) -> float:
        return max((r.completion for r in self.results), default=0.0)

    def device_busy(self, device: Optional[int] = None) -> float:
        if not self.timeline and self.busy is not None:
            # timeline-off run: the accumulators are the only record
            return (sum(self.busy) if device is None
                    else self.busy[device])
        return sum(k.end - k.start for k in self.timeline
                   if device is None or k.device == device)

    def utilization(self) -> float:
        """Aggregate utilization: busy time over makespan x devices."""
        ms = self.makespan
        return self.device_busy() / (ms * self.devices) if ms > 0 else 0.0

    def per_device_utilization(self) -> List[float]:
        ms = self.makespan
        if ms <= 0:
            return [0.0] * self.devices
        return [self.device_busy(d) / ms for d in range(self.devices)]


class SimScheduler:
    def __init__(self, tasks: List[TaskSpec], mode: Mode,
                 profiled: Optional[ProfiledData] = None,
                 pipeline_depth: int = 2, feedback: bool = True,
                 epsilon: float = EPSILON,
                 measurement_overhead: float = 0.0,
                 jitter: float = 0.0, seed: int = 0,
                 trace: str = "list", reference: bool = False,
                 devices: int = 1,
                 discipline: DisciplineSpec = "least_loaded",
                 queue_discipline="fifo",
                 steal: bool = True,
                 online=None,
                 interference=None,
                 interference_env=None,
                 jobstore=None,
                 fault_plan=None,
                 job_ids=None,
                 seq_base=None,
                 reference_core: bool = False,
                 record_timeline: bool = True):
        """measurement_overhead: multiplier on kernel durations (the paper's
        20-80% measuring-stage slowdown), used to simulate the measurement
        phase. jitter: multiplicative gaussian noise on true durations/gaps
        (run-to-run variance the SK/SG averages + feedback must absorb).
        trace/reference forward to the per-device FikitPolicy (trace sink
        selection; the O(n) reference oracle for differential testing).
        devices/discipline/steal configure the PlacementLayer: K serial
        device timelines, device election per task, and idle-device work
        stealing (no-ops at devices=1). queue_discipline selects the
        per-level intra-device queue ordering ("fifo" default / "sjf" /
        "edf" — see repro_torch.core.queues.QUEUE_DISCIPLINES); TaskSpec.deadline
        tags flow onto every kernel request for edf levels and the
        SimReport.deadline_misses counter. online (None / True /
        repro_torch.core.online.OnlineConfig) enables the live SK/SG refinement
        loop: every simulated kernel completion feeds the
        OnlineMeasurement, epoch commits reload the shared profile
        mid-run, and SimReport.online_stats carries the counters; None
        (default) builds nothing and is decision-trace-identical to the
        pre-online simulator. interference (None / True / mapping /
        repro_torch.core.interference.InterferenceModel) enables
        interference-aware gap filling: fill candidates are bounded by
        idle_time / coeff(holder_class, filler_class) and the gap is
        debited by the effective (scaled) duration; None or a disabled
        model keeps every decision bit-identical to interference-off.
        interference_env ({(holder_class, filler_class): slowdown})
        configures the SIMULATED PHYSICAL contention: a filler kernel
        sharing the device with a gap holder runs slowdown x longer,
        keyed by the GROUND-TRUTH classes from TraceKernel.kclass —
        independent of what the scheduler believes, so a wrong model
        visibly hurts JCT.

        reference_core=True keeps the original per-event loop (string-
        dispatched events, one method call per event) as the driver —
        the O(n)-style reference the fast-core differential suite
        (tests/test_sim_fastcore.py) pins the default core against. The
        default fast core processes the SAME events in the SAME order
        through the SAME placement/policy stack — only the event
        representation changes (integer-coded flat heap entries,
        slot-indexed per-task kernel records, hoisted feature flags) —
        so decision traces and timelines are bit-identical by
        construction AND by test. An attached jobstore or fault_plan
        automatically selects the reference core (the ops plane hooks
        live only there; both are I/O-bound anyway).
        record_timeline=False skips building the per-kernel
        ``KernelExec`` timeline (hundreds of MB at fleet scale) while
        keeping per-device busy-time accumulators, so
        ``SimReport.utilization``/``per_device_utilization`` still work.

        jobstore (None / path / repro_torch.core.jobstore.JobStore) attaches
        the durable ops plane: submissions, per-kernel completion
        watermarks (written at each kernel boundary BEFORE the boundary
        is otherwise processed — the write-ahead contract crash recovery
        rides on), terminal states, and profile snapshots. The store
        only OBSERVES: decisions are bit-identical with or without one.
        fault_plan (repro_torch.core.faults.FaultPlan) scripts lifecycle verbs
        and/or a process crash at global kernel-boundary indices; an
        inert plan is decision-trace-identical to None. job_ids/seq_base
        are the recovery inputs (see ``SimScheduler.recover``): the
        persistent store ids to keep recording under and each task's
        completion watermark, so a resumed task's completions land at
        their original stream indices."""
        self.tasks = tasks
        self.mode = mode
        self.profiled = profiled or ProfiledData()
        self.meas_ovh = measurement_overhead
        self.jitter = jitter
        self._rng = _random.Random(seed)

        self._heap: List[tuple] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.devices = devices
        self.device_free = [0.0] * devices
        self.record_timeline = record_timeline
        self.timeline: List[KernelExec] = []
        self._busy = [0.0] * devices
        self.events = 0
        self.results = [TaskResult(arrival=t.arrival) for t in tasks]
        n = len(tasks)
        self._next_k = [0] * n          # next kernel index to issue
        self._done_k = [0] * n          # kernels completed
        self._issued = [0] * n
        self._pending_issue: List[Optional[int]] = [None] * n
        # ops plane: durable store + scripted faults + lifecycle verbs
        self.jobstore = coerce_store(jobstore)
        self.fault_plan = fault_plan
        self.job_ids: List[Optional[int]] = (
            list(job_ids) if job_ids is not None else [None] * n)
        self.seq_base: List[int] = (
            list(seq_base) if seq_base is not None else [0] * n)
        self.cancelled: set = set()
        self.paused_tasks: set = set()
        self._begun = [False] * n
        self._snap_commits = 0
        # the fast core has no ops-plane hooks: a durable store or a
        # scripted fault plan pins the run to the reference loop
        self.reference_core = bool(reference_core)
        self._use_fast = (not reference_core and self.jobstore is None
                          and fault_plan is None)
        self.interference = InterferenceModel.coerce(interference)
        if self.interference is not None and self.interference.enabled:
            # expose on the shared profile so checkpointing can persist
            # the (possibly online-refined) coefficient table
            self.profiled.interference = self.interference
        self._ienv = dict(interference_env) if interference_env else None
        self._true_class = {}
        if self._ienv is not None:
            for ti, t in enumerate(tasks):
                for k in t.kernels:
                    self._true_class[(ti, k.kid)] = \
                        k.kclass or COMPUTE_BOUND
        cfg = OnlineConfig.coerce(online)
        self.online = (OnlineMeasurement(self.profiled, cfg,
                                         clock=lambda: self.now,
                                         interference=self.interference)
                       if cfg is not None else None)
        # single-threaded discrete-event driver: elide the queue lock
        self.placement = PlacementLayer(devices, mode, self.profiled,
                                        discipline=discipline, steal=steal,
                                        queue_discipline=queue_discipline,
                                        pipeline_depth=pipeline_depth,
                                        feedback=feedback, epsilon=epsilon,
                                        clock=lambda: self.now,
                                        launch=self._device_launch,
                                        threadsafe=False, trace=trace,
                                        reference=reference,
                                        online=self.online,
                                        interference=self.interference)
        # single-device alias: the decision core the differential suite
        # diffs against a bare FikitPolicy (placement K=1 is pass-through)
        self.policy = self.placement.policies[0]
        self.queues = self.policy.queues

    # ----------------------------------------------------------------- noise
    def _noisy(self, x: float) -> float:
        if self.jitter <= 0:
            return x
        return x * max(0.05, 1.0 + self._rng.gauss(0.0, self.jitter))

    # ------------------------------------------------------------- event API
    def _push(self, time: float, kind: str, payload: tuple) -> None:
        heapq.heappush(self._heap, (time, next(self._seq), kind, payload))

    def run(self) -> SimReport:
        if self._use_fast:
            self._run_fast_loop()
        else:
            self._run_reference_loop()
        return self._report()

    def _run_reference_loop(self) -> None:
        """The original per-event loop: one string-dispatched method call
        per event. Survives as the fast core's differential oracle and as
        the only core with ops-plane hooks (jobstore writes, fault-plan
        boundaries)."""
        if self.jobstore is not None:
            # write-ahead the whole workload before the clock starts: a
            # crash BEFORE a task's arrival event must not lose the task
            # (it recovers as ``submitted``); arrival advances the row to
            # ``running`` via the same upsert
            for i, t in enumerate(self.tasks):
                state = (_js.CANCELLED if i in self.cancelled
                         else _js.SUBMITTED)
                self.job_ids[i] = self.jobstore.record_submit(
                    self.job_ids[i], t.key, t.priority,
                    n_kernels=self.seq_base[i] + len(t.kernels),
                    spec=spec_to_obj(t), deadline=t.deadline,
                    state=state, at=self.now)
        for i, t in enumerate(self.tasks):
            self._push(t.arrival, "arrival", (i,))
        events = 0
        while self._heap:
            self.now, _, kind, payload = heapq.heappop(self._heap)
            events += 1
            getattr(self, "_on_" + kind)(*payload)
        self.events = events

    def _report(self) -> SimReport:
        online_stats = None
        if self.online is not None and self.online.config.enabled:
            self.online.commit()       # flush the partial final epoch
            online_stats = self.online.stats()
        if self.jobstore is not None:
            # final checkpoint: latest (possibly online-refined) SK/SG +
            # fold the WAL so a subsequent cold open reads one file
            self.jobstore.snapshot_profiles(self.profiled, at=self.now)
            self.jobstore.checkpoint()
        tagged = [(t, r) for t, r in zip(self.tasks, self.results)
                  if t.deadline is not None]
        return SimReport(self.results, self.timeline,
                         fills=self.placement.fill_count,
                         overshoot_time=self.placement.overshoot_time,
                         devices=self.devices,
                         steals=self.placement.steal_count,
                         deadline_misses=sum(1 for t, r in tagged
                                             if r.completion > t.deadline),
                         deadlines_tagged=len(tagged),
                         online_stats=online_stats,
                         events=self.events,
                         busy=list(self._busy))

    # ------------------------------------------------------------- fast core
    #: integer event codes of the fast core's flat heap entries
    #: ``(time, seq, code, task, ...)`` — ordering semantics identical to
    #: the reference core's ``(time, seq, kind, payload)`` entries (ties
    #: resolve by insertion order via the shared seq counter)
    _EV_ARRIVAL, _EV_ISSUE, _EV_KERNEL_END = 0, 1, 2

    def _run_fast_loop(self) -> None:
        """The fleet-scale event core: the same client/device event model
        as ``_run_reference_loop``, restructured for throughput —
        integer-coded flat heap tuples (no nested payload allocation, no
        string dispatch), slot-indexed per-task kernel records (kid/
        duration/gap lists replace per-event dataclass attribute chains),
        locally-bound hot callables, and feature flags (jitter) hoisted
        out of the loop. Every event is processed in the same order with
        the same placement/policy calls, so decision traces, timelines,
        results, and RNG draw sequences are bit-identical to the
        reference core — pinned by ``tests/test_sim_fastcore.py``."""
        tasks = self.tasks
        placement = self.placement
        p_task_begin = placement.task_begin
        p_task_end = placement.task_end
        p_kernel_end = placement.kernel_end
        p_fill_complete = placement.fill_complete
        p_submit = placement.submit
        results = self.results
        issued = self._issued
        done_k = self._done_k
        next_k = self._next_k
        pending = self._pending_issue
        cancelled = self.cancelled
        begun = self._begun
        heap = self._heap
        push = heapq.heappush
        pop = heapq.heappop
        tick = self._seq.__next__
        jit = self.jitter > 0
        noisy = self._noisy
        _KR = KernelRequest

        # slot-indexed task/kernel records: one flat list per field,
        # indexed by (task, kernel) — the hot loop never walks a
        # TaskSpec/TraceKernel attribute chain
        nk: List[int] = []
        kkid: List[list] = []
        kdur: List[list] = []
        kgap: List[list] = []
        keys: List = []
        prios: List[int] = []
        maxin: List[int] = []
        dls: List = []
        arrs: List[float] = []
        for t in tasks:
            ks = t.kernels
            nk.append(len(ks))
            kkid.append([k.kid for k in ks])
            kdur.append([k.duration for k in ks])
            kgap.append([k.gap_after for k in ks])
            keys.append(t.key)
            prios.append(t.priority)
            maxin.append(t.max_inflight)
            dls.append(t.deadline)
            arrs.append(t.arrival)

        def emit_kernel_end(ti, ki, filler, device, start, end):
            push(heap, (end, tick(), 2, ti, ki, filler, device, start, end))

        self._emit_kernel_end = emit_kernel_end

        def issue(ti, ki):
            issued[ti] += 1
            next_k[ti] = ki + 1
            now = self.now
            req = _KR(task_key=keys[ti], kernel_id=kkid[ti][ki],
                      priority=prios[ti], task_instance=ti, seq_index=ki,
                      submit_time=now, payload=kdur[ti][ki],
                      deadline=dls[ti])
            # async clients schedule the next host-side issue now
            if maxin[ti] > 1 and ki + 1 < nk[ti]:
                g = kgap[ti][ki]
                push(heap, (now + (noisy(g) if jit else g),
                            tick(), 1, ti, ki + 1))
            p_submit(req)

        def try_issue(ti, ki):
            if ti in cancelled or ki >= nk[ti]:
                return
            if issued[ti] - done_k[ti] >= maxin[ti]:
                pending[ti] = ki          # wait for a flight slot
                return
            issue(ti, ki)

        for i in range(len(tasks)):
            push(heap, (arrs[i], tick(), 0, i))
        events = 0
        while heap:
            ev = pop(heap)
            self.now = ev[0]
            code = ev[2]
            ti = ev[3]
            events += 1
            if code == 2:                              # kernel_end
                ki = ev[4]
                done_k[ti] = ki + 1
                if ev[5]:                              # filler completion
                    p_fill_complete(ev[6])
                kid = kkid[ti][ki]
                if ti in cancelled:
                    # a cancelled task's in-flight kernel ran to
                    # completion (non-preemptible); observe, issue nothing
                    p_kernel_end(ti, kid, last=True,
                                 actual_gap=kgap[ti][ki],
                                 start=ev[7], end=ev[8])
                    continue
                last = ki == nk[ti] - 1
                if last:
                    results[ti].completion = self.now
                    for nxt in p_task_end(ti):         # EXCLUSIVE admission
                        try_issue(nxt, 0)
                elif maxin[ti] == 1:
                    # synchronous client: consume result, issue next
                    g = kgap[ti][ki]
                    push(heap, (self.now + (noisy(g) if jit else g),
                                tick(), 1, ti, ki + 1))
                else:
                    pi = pending[ti]
                    if pi is not None:
                        pending[ti] = None
                        issue(ti, pi)                  # flight slot freed
                p_kernel_end(ti, kid, last=last,
                             actual_gap=kgap[ti][ki],
                             start=ev[7], end=ev[8])
            elif code == 1:                            # host issue
                try_issue(ti, ev[4])
            else:                                      # arrival
                if ti in cancelled:
                    continue
                begun[ti] = True
                if p_task_begin(ti, keys[ti], prios[ti],
                                arrival=arrs[ti]):
                    try_issue(ti, 0)
        self.events = events

    # --------------------------------------------------------------- clients
    def _on_arrival(self, ti: int) -> None:
        if ti in self.cancelled:       # cancelled before it ever arrived
            return
        task = self.tasks[ti]
        self._begun[ti] = True
        if self.jobstore is not None:
            # upsert: a recovery re-submission keeps the original row
            # (full spec, kernel count, completions); only state advances
            self.job_ids[ti] = self.jobstore.record_submit(
                self.job_ids[ti], task.key, task.priority,
                n_kernels=self.seq_base[ti] + len(task.kernels),
                spec=spec_to_obj(task), deadline=task.deadline,
                at=self.now)
        if self.placement.task_begin(ti, task.key, task.priority,
                                     arrival=self.results[ti].arrival):
            self._on_issue(ti, 0)

    def _on_issue(self, ti: int, ki: int) -> None:
        """Host of task ti is ready to issue kernel ki."""
        if ti in self.cancelled:
            return
        task = self.tasks[ti]
        if ki >= len(task.kernels):
            return
        if self._issued[ti] - self._done_k[ti] >= task.max_inflight:
            self._pending_issue[ti] = ki          # wait for a flight slot
            return
        self._issue(ti, ki)

    def _issue(self, ti: int, ki: int) -> None:
        task = self.tasks[ti]
        self._issued[ti] += 1
        self._next_k[ti] = ki + 1
        req = KernelRequest(task_key=task.key,
                            kernel_id=task.kernels[ki].kid,
                            priority=task.priority, task_instance=ti,
                            seq_index=ki, submit_time=self.now,
                            payload=task.kernels[ki].duration,
                            deadline=task.deadline)
        # async clients schedule the next host-side issue now
        if task.max_inflight > 1 and ki + 1 < len(task.kernels):
            self._push(self.now + self._noisy(task.kernels[ki].gap_after),
                       "issue", (ti, ki + 1))
        self.placement.submit(req)

    # ---------------------------------------------------------------- device
    def _device_launch(self, device: int, req: KernelRequest,
                       filler: bool) -> None:
        """Placement launch hook: put the request on ``device``'s serial
        timeline."""
        dur = self._noisy(float(req.payload)) * (1.0 + self.meas_ovh)
        if filler and self._ienv is not None:
            # physical contention: a filler co-running against the gap
            # holder is slowed by the GROUND-TRUTH class-pair factor,
            # regardless of what the scheduler's model predicted
            gk = self.placement.policies[device].gap_kinfo
            if gk is not None:
                h = self._true_class.get(gk, COMPUTE_BOUND)
                f = self._true_class.get(
                    (req.task_instance, req.kernel_id), COMPUTE_BOUND)
                dur *= self._ienv.get((h, f), 1.0)
        start = max(self.now, self.device_free[device])
        end = start + dur
        self.device_free[device] = end
        self._busy[device] += dur
        ti = req.task_instance
        if self.results[ti].start < 0:
            self.results[ti].start = start
        if self.record_timeline:
            self.timeline.append(KernelExec(ti, req.seq_index, start, end,
                                            filler=filler, device=device))
        self._emit_kernel_end(ti, req.seq_index, filler, device, start, end)

    def _emit_kernel_end(self, ti: int, ki: int, filler: bool, device: int,
                         start: float, end: float) -> None:
        """Schedule the completion event for a launched kernel. The fast
        core shadows this with its flat-tuple emitter at loop start; the
        ordering key (time, seq) is identical either way."""
        self._push(end, "kernel_end", (ti, ki, filler, device, start, end))

    def _on_kernel_end(self, ti: int, ki: int, filler: bool, device: int,
                       start: float, end: float) -> None:
        task = self.tasks[ti]
        if self.jobstore is not None:
            # WRITE-AHEAD: the completion record is this boundary's
            # commit point — durable before ANY scheduling side-effect,
            # so a crash anywhere below loses nothing and recovery
            # re-submits exactly the un-recorded suffix
            self.jobstore.record_completion(self.job_ids[ti],
                                            self.seq_base[ti] + ki,
                                            at=self.now)
        self._done_k[ti] = ki + 1
        if filler:
            self.placement.fill_complete(device)
        if ti in self.cancelled:
            # a cancelled task's in-flight kernel ran to completion
            # (kernels are non-preemptible); observe it, issue nothing
            self.placement.kernel_end(ti, task.kernels[ki].kid, last=True,
                                      actual_gap=task.kernels[ki].gap_after,
                                      start=start, end=end)
            self._fault_boundary()
            return
        last = ki == len(task.kernels) - 1
        if last:
            self.results[ti].completion = self.now
            for nxt in self.placement.task_end(ti):  # EXCLUSIVE admission
                self._on_issue(nxt, 0)
        elif task.max_inflight == 1:
            # synchronous client: host consumes result, then issues next
            self._push(self.now + self._noisy(task.kernels[ki].gap_after),
                       "issue", (ti, ki + 1))
        elif self._pending_issue[ti] is not None:
            nxt = self._pending_issue[ti]
            self._pending_issue[ti] = None
            self._issue(ti, nxt)                   # flight slot freed
        self.placement.kernel_end(ti, task.kernels[ki].kid, last=last,
                                  actual_gap=task.kernels[ki].gap_after,
                                  start=start, end=end)
        if self.jobstore is not None:
            if last:
                self.jobstore.record_state(self.job_ids[ti], _js.DONE,
                                           at=self.now)
            if (self.online is not None
                    and self.online.commits != self._snap_commits):
                # an online epoch committed refined SK/SG this boundary:
                # checkpoint so recovery resumes with what was learned
                self._snap_commits = self.online.commits
                self.jobstore.snapshot_profiles(self.profiled, at=self.now)
        self._fault_boundary()

    # -------------------------------------------------------- ops plane
    def _fault_boundary(self) -> None:
        """Consult the fault plan at a kernel boundary — the only place
        faults are injected (kernels are non-preemptible). Scripted
        verbs apply BEFORE a scripted crash at the same boundary, so a
        cancel-then-crash persists the cancel."""
        if self.fault_plan is None:
            return
        crash, verbs = self.fault_plan.at_boundary()
        for v in verbs:
            verb, args = v[0], v[1:]
            if verb == "cancel":
                self.cancel(*args)
            elif verb == "pause":
                self.pause(*args)
            elif verb == "resume":
                self.resume(*args)
            else:
                raise ValueError(f"unknown fault-plan verb {v!r}")
        if crash:
            self.fault_plan.crash()

    def cancel(self, ti: int) -> List[KernelRequest]:
        """Cancel task ``ti``: purge its queued requests (in-flight
        kernels finish — non-preemptible), retire it, record the
        terminal state. Returns the purged requests."""
        if ti in self.cancelled:
            return []
        if self._begun[ti] and self._done_k[ti] >= len(self.tasks[ti].kernels):
            return []                  # raced completion: already DONE
        self.cancelled.add(ti)
        self.paused_tasks.discard(ti)
        self._pending_issue[ti] = None
        purged: List[KernelRequest] = []
        if self._begun[ti]:
            purged, admitted = self.placement.cancel(ti)
            for nxt in admitted:       # EXCLUSIVE: next waiter admitted
                self._on_issue(nxt, 0)
        if self.jobstore is not None and self.job_ids[ti] is not None:
            self.jobstore.record_state(self.job_ids[ti], _js.CANCELLED,
                                       at=self.now)
        return purged

    def pause(self, ti: int) -> bool:
        """Pause task ``ti`` (defers to its next kernel boundary when
        kernels are in flight — returns False then, True when the pause
        took effect immediately). The client keeps issuing; its requests
        buffer with the detached backlog until ``resume``."""
        if ti in self.paused_tasks:
            return True
        if ti in self.cancelled or not self._begun[ti]:
            raise ValueError(f"cannot pause task {ti} "
                             f"(cancelled or not yet arrived)")
        landed = self.placement.pause(ti)
        self.paused_tasks.add(ti)
        if self.jobstore is not None and self.job_ids[ti] is not None:
            self.jobstore.record_state(self.job_ids[ti], _js.PAUSED,
                                       at=self.now)
        return landed

    def resume(self, ti: int, device: Optional[int] = None) -> int:
        """Re-admit a paused task (on ``device``, or wherever the
        placement discipline elects). Returns the hosting device."""
        if ti not in self.paused_tasks:
            raise ValueError(f"task {ti} is not paused")
        d = self.placement.resume(ti, device)
        self.paused_tasks.discard(ti)
        if self.jobstore is not None and self.job_ids[ti] is not None:
            self.jobstore.record_state(self.job_ids[ti], _js.RUNNING,
                                       at=self.now)
        return d

    @classmethod
    def recover(cls, jobstore, mode: Mode, *, include_paused: bool = False,
                cold_start: bool = False, **kwargs) -> "SimScheduler":
        """Rebuild a simulator from a store's incomplete jobs: each
        job's REMAINING kernel suffix re-submits in stream order under
        its original job id and completion watermark (so recovered
        completions land at their original stream indices), and the
        latest profile snapshot — online-learned SK/SG included —
        reloads unless ``profiled=`` overrides it. Paused jobs stay
        paused in the store across a restart unless ``include_paused``.
        """
        store = coerce_store(jobstore)
        specs, ids, bases = store.recovery_plan(
            include_paused=include_paused)
        profiled = kwargs.pop("profiled", None)
        if profiled is None:
            profiled = store.load_profiles(cold_start=cold_start)
        return cls(specs, mode, profiled=profiled, jobstore=store,
                   job_ids=ids, seq_base=bases, **kwargs)


# ---------------------------------------------------------------------------
# Measurement phase (paper Fig 3/6): run a task solo T times, record device
# timeline, emit SK/SG statistics. Durations are what the device measured;
# the JCT overhead of measuring (20-80%) applies to the run's wall time.
# ---------------------------------------------------------------------------
def measure_task(spec: TaskSpec, T: int = 10, jitter: float = 0.0,
                 measurement_overhead: float = 0.5, seed: int = 0,
                 ) -> Tuple["Profiler", List[float]]:
    """Returns (profiler with T solo runs recorded, per-run measured JCTs)."""
    prof = Profiler(spec.key)
    jcts = []
    for t in range(T):
        solo = TaskSpec(spec.key, spec.priority, spec.kernels, arrival=0.0,
                        max_inflight=spec.max_inflight)
        sim = SimScheduler([solo], Mode.EXCLUSIVE, jitter=jitter,
                           seed=seed * 10_007 + t,
                           measurement_overhead=measurement_overhead)
        rep = sim.run()
        jcts.append(rep.jct(0))
        prof.start_run()
        tl = sorted(rep.timeline, key=lambda k: k.start)
        for i, k in enumerate(tl):
            kid = spec.kernels[k.seq].kid
            # the device measured the kernel under measurement overhead;
            # report the de-rated (true) duration like cudaEvent timing
            prof.record(kid, (k.end - k.start) / (1.0 + measurement_overhead),
                        kclass=spec.kernels[k.seq].kclass)
            if i < len(tl) - 1:
                prof.record_gap(max(0.0, tl[i + 1].start - k.end))
        prof.end_run()
    return prof, jcts


def profile_tasks(specs: List[TaskSpec], T: int = 10, jitter: float = 0.0,
                  measurement_overhead: float = 0.5, seed: int = 0,
                  ) -> ProfiledData:
    data = ProfiledData()
    for i, spec in enumerate(specs):
        prof, _ = measure_task(spec, T=T, jitter=jitter,
                               measurement_overhead=measurement_overhead,
                               seed=seed + i)
        data.load(prof.statistics())
    return data
