"""Engine-agnostic FIKIT policy core — ONE scheduling state machine.

The paper's scheduling contribution (priority queues, holder election,
SG-gap prediction, BestPrioFit filling with real-time feedback) used to be
implemented twice: once in the discrete-event ``SimScheduler`` and once in
the threaded ``WallClockEngine``. ``FikitPolicy`` extracts the shared state
machine so a scheduling decision can never drift between the two; both
engines are now thin drivers over this class.

Responsibilities owned by the policy (and ONLY by the policy):

- holder election — the highest-priority active task, ties broken by
  (arrival, instance id); the election result is CACHED and revalidated
  only on ``task_begin``/``task_end`` (the only events that can change
  it), so the per-submit/per-kernel-end ``holder()`` probe is O(1);
- request routing — holder-direct launch, equal-priority FIFO sharing
  (paper case C), or park in the priority queues Q0..Q9;
- gap open/close with real-time feedback — a holder kernel's completion
  opens the predicted SG[kid] gap (skipping gaps <= epsilon); the holder's
  next actual submit closes it early (Fig 12), bounding prediction-error
  propagation;
- the bounded ``pipeline_depth`` BestPrioFit fill loop — at most
  ``pipeline_depth`` fillers sit in the device queue at once;
- release-on-task-done — when the holder retires, queued requests of the
  new holder (and its equal-priority peers) are released; with no active
  task the queues drain FIFO;
- overshoot accounting — filler time past the actual gap end is the
  paper's "overhead 2";
- EXCLUSIVE admission — tasks serialized in begin order.

Engine interface (dependency-injected, so the policy never touches a
thread, an event heap, or a device):

- ``clock()``   -> float      current time (sim: virtual now; wall: perf_counter)
- ``launch(req, filler)``     put a request on the serial device queue

Modes
-----
EXCLUSIVE — tasks serialized in arrival order; admission gated in
            ``task_begin``/``task_end``.
SHARING   — every submit launches immediately (default GPU sharing).
FIKIT     — priority queues + SG-gap filling + feedback (the paper).
PREEMPT   — kernel-boundary preemptive sharing (the paper's preemptive
            baseline, Figs 19/20; cf. arXiv 2401.16529): while any
            strictly-higher-priority task is active, lower-priority
            submits are parked in the priority queues and released only
            when no higher-priority task remains active. No gap filling —
            the device is reserved for the high-priority tier, so
            low-priority work advances only between high-priority tasks.
            Kernels stay non-preemptible; preemption happens at kernel
            launch boundaries (a running kernel always finishes).

Decision trace
--------------
Every decision appends one tuple to ``self.trace``:

    ("begin",  instance)            task became active
    ("defer",  instance)            EXCLUSIVE admission parked the task
    ("admit",  instance)            EXCLUSIVE admission released the task
    ("end",    instance)            task retired
    ("holder", instance | None)     holder transition (after begin/end)
    ("launch", instance, seq)       direct launch (holder / sharing / FIFO)
    ("queue",  instance, seq)       parked in the priority queues
    ("fill",   instance, seq)       BestPrioFit gap fill launch
    ("release", instance, seq)      released on holder retirement
    ("drain",  instance, seq)       FIFO drain with no active task
    ("gap_open",  instance, predicted)
    ("gap_close", instance)
    ("detach", instance)            task migrated OUT (placement steal)
    ("attach", instance)            task migrated IN  (placement steal)
    ("cancel", instance)            task cancelled (ops-plane verb);
                                    always followed by the ("end", ...)
                                    retirement events

The ``detach``/``attach`` pair is the multi-device placement layer's
migration seam (``repro_torch.core.placement.PlacementLayer``): a fully-parked
task leaves one device's policy and joins another's. Neither event can
occur on a single-device system, so a K=1 placement trace is identical to
a bare policy trace — the property the placement differential tests pin.

The trace is what the differential tests compare between engines: identical
scenario -> identical trace, by construction and by test.

The trace destination is a pluggable sink (``trace=`` ctor arg):

    "list" (default) — ``ListTrace``, an unbounded list; what tests diff.
    "ring"           — ``RingTrace``, a bounded ring buffer keeping the
                       most recent ``DEFAULT_RING`` entries (long-running
                       serving with bounded memory); an int selects a
                       custom capacity.
    "off"            — ``NullTrace``; tracing is skipped entirely (the
                       append AND the tuple construction), so production
                       mode pays nothing per decision.
    any object with ``.append``   — custom sink. ``enabled`` is read ONCE
                       at policy construction: a sink carrying
                       ``enabled = False`` before the policy is built
                       suppresses tuple construction; flipping it later
                       has no effect.
"""
from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.core.fikit import EPSILON, best_prio_fit, best_prio_fit_scan
from repro_torch.core.kernel_id import KernelID
from repro_torch.core.profiler import ProfiledData
from repro_torch.core.queues import PriorityQueues, QueueDisciplineSpec
from repro_torch.core.task import KernelRequest, TaskKey


class Mode(enum.Enum):
    EXCLUSIVE = "exclusive"
    SHARING = "sharing"
    FIKIT = "fikit"
    PREEMPT = "preempt"


#: Modes that route through the priority queues.
QUEUED_MODES = (Mode.FIKIT, Mode.PREEMPT)

#: Default capacity of a ``trace="ring"`` sink.
DEFAULT_RING = 4096


class ListTrace(list):
    """Unbounded in-memory decision trace (the default; what tests diff)."""
    enabled = True


class RingTrace(deque):
    """Bounded ring buffer: keeps the most recent ``maxlen`` decisions."""
    enabled = True


class NullTrace:
    """Disabled trace: every decision costs nothing (no tuple is built)."""
    enabled = False

    def append(self, item) -> None:  # pragma: no cover - never called hot
        pass

    def __len__(self) -> int:
        return 0

    def __iter__(self):
        return iter(())


TraceSpec = Union[str, int, ListTrace, RingTrace, NullTrace]


def make_trace_sink(spec: TraceSpec = "list"):
    if spec == "list" or spec is None:
        return ListTrace()
    if spec == "off":
        return NullTrace()
    if spec == "ring":
        return RingTrace(maxlen=DEFAULT_RING)
    if isinstance(spec, int):
        return RingTrace(maxlen=spec)
    if hasattr(spec, "append"):
        return spec
    raise ValueError(f"unknown trace sink spec: {spec!r}")


@dataclass
class ActiveTask:
    """Policy-side record of a running task instance."""
    instance: int
    key: TaskKey
    priority: int
    arrival: float


class FikitPolicy:
    """The FIKIT scheduling state machine, engine-agnostic.

    Drivers call, in event order:

    - ``task_begin(instance, key, priority)`` when a task starts; the
      return value says whether the task may issue now (EXCLUSIVE gates
      admission; every other mode admits immediately).
    - ``submit(req)`` for every kernel request the client issues; the
      policy either launches it (via the injected ``launch`` hook) or
      parks it in the priority queues. Returns True iff launched.
    - ``fill_complete()`` when a *filler* kernel finishes on the device
      (frees a pipeline-depth slot, accrues overshoot).
    - ``kernel_end(instance, kernel_id, ...)`` when any kernel finishes
      (opens the holder's predicted gap, runs the fill loop).
    - ``task_end(instance)`` when a task retires; returns the instances
      newly admitted by EXCLUSIVE serialization (empty otherwise).

    ``discipline`` selects the per-level queue discipline
    (``repro_torch.core.queues.QUEUE_DISCIPLINES``: ``"fifo"`` — the paper's
    pinned default, ``"sjf"``, ``"edf"`` — or a per-level mapping/
    sequence). It governs how parked requests are ordered WITHIN a
    priority level (drain pops and gap-fill selection); cross-level
    priority order, holder election, and release semantics are untouched.

    ``threadsafe=False`` elides the priority-queue RLock for
    single-threaded drivers (the simulator); the threaded wall-clock
    engine keeps it. ``reference=True`` switches the fast paths back to
    their O(n) reference implementations (linear-scan BestPrioFit,
    scan-selected discipline pops, re-elected holder on every probe) —
    the oracle the differential tests compare the indexed/cached path
    against.

    ``online`` optionally attaches an ``repro_torch.core.online.
    OnlineMeasurement``: the policy then reports gap prediction error
    (predicted SG vs the driver-known actual gap) into its drift
    counters at the exact point the Fig-12 feedback operates. The policy
    NEVER makes a different decision because of it — duration/gap
    refinement reaches decisions only through ``profiled`` version
    bumps, so ``online=None`` (the default) is decision-trace-identical
    to the pre-online implementation.

    ``interference`` optionally attaches an enabled
    ``repro_torch.core.interference.InterferenceModel``: gap-fill candidates
    are then scored by predicted HOLDER SLOWDOWN — a candidate of
    resource class ``c`` under a holder-gap kernel of class ``h`` fits
    only while its predicted duration stays under
    ``gap_remaining / coeff(h, c)``, and each fill debits the gap by the
    coefficient-scaled effective duration. With ``interference=None``
    (the pinned default) or a disabled model every decision is
    bit-identical to the pre-interference implementation.
    """

    def __init__(self, mode: Mode,
                 profiled: Optional[ProfiledData] = None, *,
                 pipeline_depth: int = 2, feedback: bool = True,
                 epsilon: float = EPSILON,
                 clock: Callable[[], float] = lambda: 0.0,
                 launch: Callable[[KernelRequest, bool], None] = None,
                 threadsafe: bool = True,
                 trace: TraceSpec = "list",
                 discipline: QueueDisciplineSpec = "fifo",
                 reference: bool = False,
                 online=None,
                 interference=None):
        if launch is None:
            raise TypeError("FikitPolicy requires a launch hook")
        self.mode = mode
        self.online = online
        self.interference = interference
        self._interference_on = (interference is not None
                                 and getattr(interference, "enabled",
                                             False))
        self.profiled = profiled or ProfiledData()
        self.pipeline_depth = max(1, pipeline_depth)
        self.feedback = feedback
        self.epsilon = epsilon
        self._clock = clock
        self._launch_hook = launch
        self.reference = reference
        self.discipline = discipline
        self._fit = best_prio_fit_scan if reference else best_prio_fit

        self.queues = PriorityQueues(profiled=self.profiled,
                                     threadsafe=threadsafe,
                                     discipline_by_level=discipline,
                                     reference=reference,
                                     interference=interference)
        self.active: Dict[int, ActiveTask] = {}
        self.trace = make_trace_sink(trace)
        self._trace_on = getattr(self.trace, "enabled", True)
        # EXCLUSIVE admission state
        self._excl_running: Optional[int] = None
        self._excl_waiting: List[int] = []
        # gap state
        self.gap_open = False
        self.gap_remaining = 0.0
        self.gap_end_actual: Optional[float] = None
        #: (instance, kernel_id) whose completion opened the current gap —
        #: pure bookkeeping (never traced, never read by decisions unless
        #: interference scoring is on); the simulator's physical
        #: interference environment reads it to slow concurrent fillers.
        self.gap_kinfo: Optional[Tuple[int, KernelID]] = None
        self._gap_class: Optional[str] = None
        self.fills_in_flight = 0
        self.fill_count = 0
        self.overshoot_time = 0.0
        self.spurious_fill_completions = 0
        self._holder: Optional[int] = None       # cached election result
        self._last_holder: Optional[int] = None  # last traced transition

    # ------------------------------------------------------------- lifecycle
    def task_begin(self, instance: int, key: TaskKey, priority: int,
                   arrival: Optional[float] = None) -> bool:
        """Register an active task. Returns True if it may issue now."""
        if arrival is None:
            arrival = self._clock()
        at = ActiveTask(instance, key, priority, arrival)
        self.active[instance] = at
        self._consider_holder(at)
        if self._trace_on:
            self.trace.append(("begin", instance))
        admitted = True
        if self.mode is Mode.EXCLUSIVE:
            if self._excl_running is None:
                self._excl_running = instance
            else:
                self._excl_waiting.append(instance)
                if self._trace_on:
                    self.trace.append(("defer", instance))
                admitted = False
        self._note_holder()
        return admitted

    def task_end(self, instance: int) -> List[int]:
        """Retire a task. Returns instances newly admitted (EXCLUSIVE)."""
        self.active.pop(instance, None)
        if instance == self._holder:             # invalidate cache: re-elect
            self._holder = self._elect_holder()
        if self._trace_on:
            self.trace.append(("end", instance))
        admitted: List[int] = []
        if self.mode is Mode.EXCLUSIVE:
            if self._excl_running == instance:
                self._excl_running = None
                if self._excl_waiting:
                    nxt = self._excl_waiting.pop(0)
                    self._excl_running = nxt
                    if self._trace_on:
                        self.trace.append(("admit", nxt))
                    admitted.append(nxt)
        elif self.mode in QUEUED_MODES:
            self.gap_open = False
            self.gap_remaining = 0.0
            self.gap_kinfo = None
            self._gap_class = None
            self._release_new_holder()
        self._note_holder()
        return admitted

    # ------------------------------------------------------------- migration
    def detach_task(self, instance: int,
                    reqs: Optional[List[KernelRequest]] = None,
                    ) -> Tuple[ActiveTask, List[KernelRequest]]:
        """Remove ``instance`` and its parked requests WITHOUT retirement
        semantics: no release of the next holder's queue, no gap reset —
        nothing ended, the task is merely leaving for another device.

        ``reqs`` is the task's parked requests when the caller already
        tracks them (the placement layer does, keeping the steal at
        O(stream log n) indexed removes); omitted, they are collected by a
        scan over the queues. Requests come back in stream (seq) order.

        The placement layer only migrates fully-parked tasks (zero kernels
        in flight), so the detached task can never be this policy's holder:
        a holder's submits launch directly and its backlog is released the
        moment it is elected, hence a task with parked requests is always
        strictly below the holder."""
        at = self.active.pop(instance)
        if reqs is None:
            reqs = [r for r in self.queues if r.task_instance == instance]
        reqs = sorted(reqs, key=lambda r: r.seq_index)
        with self.queues.lock():
            for r in reqs:
                self.queues.remove(r)
        if instance == self._holder:           # defensive: re-elect
            self._holder = self._elect_holder()
        if self._trace_on:
            self.trace.append(("detach", instance))
        self._note_holder()
        return at, reqs

    # ------------------------------------------------------------ lifecycle
    def cancel_task(self, instance: int,
                    reqs: Optional[List[KernelRequest]] = None,
                    ) -> Tuple[List[KernelRequest], List[int]]:
        """Cancel ``instance`` at a kernel boundary: purge its parked
        requests from the priority queues (never a launched kernel —
        kernels are non-preemptible, so anything already on the device
        runs to completion), then retire it with full ``task_end``
        semantics: holder re-election, release of the new holder's
        backlog, EXCLUSIVE admission of the next waiter.

        ``reqs`` is the task's parked requests when the caller already
        tracks them (the placement layer does); omitted, they are
        collected by a queue scan. Returns ``(purged, admitted)`` — the
        purged requests in stream order (so callers can fail their
        futures / account conservation) and the instances newly admitted
        by EXCLUSIVE serialization."""
        if reqs is None:
            reqs = [r for r in self.queues if r.task_instance == instance]
        reqs = sorted(reqs, key=lambda r: r.seq_index)
        with self.queues.lock():
            for r in reqs:
                self.queues.remove(r)
        if self.mode is Mode.EXCLUSIVE and instance in self._excl_waiting:
            # a deferred task can be cancelled before it was ever admitted
            self._excl_waiting.remove(instance)
        if self._trace_on:
            self.trace.append(("cancel", instance))
        admitted = self.task_end(instance)
        return reqs, admitted

    def pause_task(self, instance: int,
                   reqs: Optional[List[KernelRequest]] = None,
                   ) -> Tuple[ActiveTask, List[KernelRequest]]:
        """``detach_task`` with holder-release semantics. A placement
        steal only ever detaches a fully-parked non-holder, but a pause
        may remove the CURRENT holder (a holder between kernels holds no
        device slot) — in that case the open gap dies with it and the
        next holder's backlog releases exactly as on retirement, so the
        device never deadlocks waiting on a paused task's submits."""
        was_holder = self.holder() == instance
        at, reqs = self.detach_task(instance, reqs)
        if was_holder and self.mode in QUEUED_MODES:
            self.gap_open = False
            self.gap_remaining = 0.0
            self.gap_kinfo = None
            self._gap_class = None
            self._release_new_holder()
        return at, reqs

    def attach_task(self, at: ActiveTask) -> None:
        """Adopt a task migrated from another device's policy, preserving
        its original arrival so holder election stays (priority, arrival,
        instance)-consistent. The caller re-submits the detached requests
        through ``submit`` afterwards so they route under THIS policy's
        holder state."""
        self.active[at.instance] = at
        self._consider_holder(at)
        if self._trace_on:
            self.trace.append(("attach", at.instance))
        self._note_holder()

    # --------------------------------------------------------------- routing
    def _consider_holder(self, at: ActiveTask) -> None:
        """Incremental holder cache update: the newcomer takes over iff it
        beats the incumbent in (priority, arrival, instance) order."""
        cur = self.active.get(self._holder) if self._holder is not None \
            else None
        if cur is None or (at.priority, at.arrival, at.instance) < \
                (cur.priority, cur.arrival, cur.instance):
            self._holder = at.instance

    def _elect_holder(self) -> Optional[int]:
        """Full election: highest-priority active task (ties: earliest
        arrival, then id). O(active); runs only on begin/end."""
        best: Optional[ActiveTask] = None
        for at in self.active.values():
            if best is None or (at.priority, at.arrival, at.instance) < \
                    (best.priority, best.arrival, best.instance):
                best = at
        return best.instance if best is not None else None

    def holder(self) -> Optional[int]:
        """Current holder — cached; O(1) on the submit/kernel_end path."""
        if self.reference:
            return self._elect_holder()
        return self._holder

    def submit(self, req: KernelRequest) -> bool:
        """Route one kernel request. Returns True iff it launched."""
        if self.mode not in QUEUED_MODES:
            self._launch(req)
            return True
        holder = self.holder()
        if holder is None or holder == req.task_instance:
            if self.gap_open and holder == req.task_instance:
                self._close_gap(holder)            # real-time feedback
            self._launch(req)
            return True
        if (self.active[req.task_instance].priority
                == self.active[holder].priority):
            self._launch(req)                      # equal prio: FIFO (case C)
            return True
        self.queues.push(req)
        if self._trace_on:
            self.trace.append(("queue", req.task_instance, req.seq_index))
        self.try_fill()                            # Fig 7: scan on enqueue
        return False

    # ------------------------------------------------------------ completion
    def fill_complete(self) -> None:
        """A filler kernel finished: free its slot, account overshoot.

        A spurious/double completion callback (an engine bug, or a device
        thread racing a retry) must not drive ``fills_in_flight`` negative
        — that would widen the pipeline-depth bound for the rest of the
        run. Clamp at zero and count the event instead."""
        if self.fills_in_flight <= 0:
            # the clamp below keeps this invariant; assert documents it
            assert self.fills_in_flight == 0, \
                "fills_in_flight must never go negative"
            self.spurious_fill_completions += 1
            return
        self.fills_in_flight -= 1
        now = self._clock()
        if self.gap_end_actual is not None and now > self.gap_end_actual:
            self.overshoot_time += now - self.gap_end_actual

    def kernel_end(self, instance: int, kernel_id: KernelID, *,
                   last: bool = False,
                   actual_gap: Optional[float] = None) -> None:
        """A kernel of ``instance`` finished on the device.

        Call ``fill_complete()`` first when the finished kernel was a
        filler. ``actual_gap`` is the true host gap following this kernel
        when the driver knows it (the simulator does); it anchors overshoot
        accounting. Wall-clock drivers pass None — the gap's actual end is
        then pinned when the holder's next submit closes it.
        """
        if self.mode is not Mode.FIKIT:
            return
        if self.holder() == instance and not last:
            at = self.active[instance]
            predicted = self.profiled.predict_gap(at.key, kernel_id)
            if (self.online is not None and actual_gap is not None
                    and predicted > self.epsilon):
                # Fig-12 drift accounting: the driver knows the true gap
                # the predicted SG is about to stand in for
                self.online.observe_gap_error(predicted, actual_gap)
            if predicted > self.epsilon:           # skip small gaps
                self.gap_open = True
                self.gap_remaining = predicted
                self.gap_kinfo = (instance, kernel_id)
                if self._interference_on:
                    self._gap_class = self.profiled.predict_class(
                        at.key, kernel_id)
                self.gap_end_actual = (
                    self._clock() + actual_gap
                    if self.feedback and actual_gap is not None else None)
                if self._trace_on:
                    self.trace.append(("gap_open", instance, predicted))
        self.try_fill()

    # ------------------------------------------------------------ gap + fill
    def _close_gap(self, holder: int) -> None:
        self.gap_open = False
        self.gap_remaining = 0.0
        self.gap_kinfo = None
        self._gap_class = None
        if self.feedback and self.gap_end_actual is None:
            # wall-clock feedback: the holder's submit IS the gap's end
            self.gap_end_actual = self._clock()
        if self._trace_on:
            self.trace.append(("gap_close", holder))

    def try_fill(self) -> None:
        """Fill an open gap (Algorithm 1, incremental with feedback and a
        bounded device-queue lookahead). PREEMPT never fills."""
        if self.mode is not Mode.FIKIT or not self.gap_open:
            return
        while (self.fills_in_flight < self.pipeline_depth
               and self.gap_remaining > 0.0):
            req, fill_time = self._fit(
                self.queues, self.gap_remaining, self.profiled,
                holder_class=self._gap_class,
                interference=(self.interference if self._interference_on
                              else None))
            if fill_time == -1:
                break
            self.fills_in_flight += 1
            self.fill_count += 1
            eff = fill_time
            if self._interference_on and self._gap_class is not None:
                fclass = self.profiled.predict_class(req.task_key,
                                                     req.kernel_id)
                eff = fill_time * self.interference.coeff(self._gap_class,
                                                          fclass)
                if self.online is not None:
                    # tag the launch so the observed duration can be
                    # matched back to its (holder, filler) class pair
                    self.online.note_fill_pair(req.task_instance,
                                               req.kernel_id,
                                               self._gap_class, fclass)
            self.gap_remaining -= eff
            self._launch(req, filler=True, tag="fill")

    def _release_new_holder(self) -> None:
        holder = self.holder()
        if holder is None:
            # drain leftovers: priority-major, per-level discipline order
            req = self.queues.pop_highest()
            while req is not None:
                self._launch(req, tag="drain")
                req = self.queues.pop_highest()
            return
        hp = self.active[holder].priority
        with self.queues.lock():
            for req in list(self.queues):
                at = self.active.get(req.task_instance)
                if req.task_instance == holder or \
                        (at is not None and at.priority == hp):
                    self.queues.remove(req)
                    self._launch(req, tag="release")

    # -------------------------------------------------------------- plumbing
    def _launch(self, req: KernelRequest, filler: bool = False,
                tag: str = "launch") -> None:
        if self._trace_on:
            self.trace.append((tag, req.task_instance, req.seq_index))
        self._launch_hook(req, filler)

    def _note_holder(self) -> None:
        h = self.holder()
        if h != self._last_holder:
            self._last_holder = h
            if self._trace_on:
                self.trace.append(("holder", h))

    # ---------------------------------------------------------------- stats
    @property
    def queued(self) -> int:
        return len(self.queues)
