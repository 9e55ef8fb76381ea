"""Async admission plane for serving: the front door between open-loop
client traffic and the FIKIT engine.

The serving substrate (``ServingSystem`` over ``WallClockEngine`` +
``PlacementLayer``) schedules whatever reaches it, but until this layer
existed every request cost a parked client thread and an unbounded
engine queue — a thread-per-request toy. The admission plane makes the
front end explicit, per Strait's framing of priority-aware inference
serving (PAPERS.md):

- **QoS classes** (``QoSClass``): named per-tenant classes, each mapped
  onto a FIKIT priority level (0 = highest), with a bounded admission
  queue, an optional default SLO deadline budget, and a continuous-
  batching cap.
- **Backpressure**: a submit into a full class queue is REJECTED
  immediately (never silently dropped) with a ``retry_after`` hint;
  submits during drain/stop are rejected with the ``requeue`` signal,
  and tickets still queued at ``stop()`` resolve as REQUEUED — both
  tell a well-behaved client to resubmit rather than that the work
  failed.
- **SLO-aware shedding**: at dispatch time a request whose EDF deadline
  budget is already unmeetable (``now + predicted JCT > deadline``,
  predicted from an EMA of observed per-service JCTs, primeable from
  measurement-phase runs) is SHED before it wastes device time. A
  never-observed (cold) service is never shed.
- **Continuous batching**: the dispatcher coalesces consecutive queued
  invocations of the same service (same class, up to ``max_batch``)
  into ONE engine task stream — one ``task_begin``, one kernel-request
  sequence, one scheduler admission — and resolves every member ticket
  when the group completes. Under overload this multiplies goodput
  without touching the scheduler.

Dispatch is strict-priority: each pass serves the highest non-empty
class first, so a lower class can only be admitted while every higher
queue is empty. That makes the shed-ordering invariant — *no high-QoS
request is shed while a lower class is admitted* — structural; the
plane still counts ``priority_inversions`` (always 0) so the property
suite can pin it.

One dispatcher thread drives everything: launches go through
``ServingSystem._invoke_async`` -> ``HookClient.run_async`` ->
``WallClockEngine.submit(on_complete=...)``, so no thread ever parks on
a per-request Future. Admission OFF (``enabled=False``, or simply not
attaching a plane) leaves the direct ``invoke`` path byte-for-byte
untouched — pinned by the trace differential in
``tests/test_admission_plane.py``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["QoSClass", "AdmissionTicket", "AdmissionPlane",
           "DEFAULT_CLASSES", "SHARD_ROUTERS", "REJECTED", "SHED",
           "COMPLETED", "FAILED", "CANCELLED", "REQUEUED"]

#: ticket outcomes
REJECTED = "rejected"      # backpressure: bounded queue full / not admitting
SHED = "shed"              # SLO-aware: deadline budget already unmeetable
COMPLETED = "completed"    # ran to completion on the engine
FAILED = "failed"          # the invocation raised (payload/host-work error)
CANCELLED = "cancelled"    # an ops-plane cancel verb hit the invocation
REQUEUED = "requeued"      # still queued at stop(): resubmit later

_UNSET = object()

#: Pluggable shard routing for backend dispatch, mirroring the placement
#: layer's device-election seam: a router maps an admitted (service,
#: qos-class-name) pair to the shard key stamped on the dispatched job —
#: ``"qos"`` keeps each QoS class together (gold jobs land on gold
#: workers), ``"service"`` keeps each service's stream together (cache
#: affinity). Register more by name.
SHARD_ROUTERS: Dict[str, object] = {
    "qos": lambda service, qos: qos,
    "service": lambda service, qos: getattr(
        getattr(service, "key", None), "process", None) or str(service),
}


@dataclass(frozen=True)
class QoSClass:
    """One tenant class: FIKIT priority + admission bound + SLO budget.

    ``priority`` is the FIKIT level (0 = highest, the paper's Q0..Q9);
    ``queue_limit`` bounds the admission queue (backpressure trips past
    it); ``deadline`` is the class's default relative SLO budget in
    seconds (None = no deadline, never shed); ``max_batch`` caps how
    many same-service invocations coalesce into one task stream."""
    name: str
    priority: int
    queue_limit: int = 256
    deadline: Optional[float] = None
    max_batch: int = 8

    def __post_init__(self):
        if not 0 <= self.priority <= 9:
            raise ValueError(f"QoSClass {self.name!r}: priority "
                             f"{self.priority} outside the paper's Q0..Q9")
        if self.queue_limit < 1:
            raise ValueError(f"QoSClass {self.name!r}: queue_limit must "
                             f"be >= 1, got {self.queue_limit}")
        if self.max_batch < 1:
            raise ValueError(f"QoSClass {self.name!r}: max_batch must "
                             f"be >= 1, got {self.max_batch}")


DEFAULT_CLASSES: Tuple[QoSClass, ...] = (
    QoSClass("gold", priority=0, queue_limit=64, max_batch=4),
    QoSClass("silver", priority=2, queue_limit=256, max_batch=8),
    QoSClass("bronze", priority=5, queue_limit=1024, max_batch=16),
)


class AdmissionTicket:
    """The client's handle on one admitted (or refused) invocation.

    Resolves exactly once; ``result(timeout)`` blocks until then and
    returns the outcome string. Rejections resolve synchronously inside
    ``submit`` — ``retry_after`` then estimates (seconds) when capacity
    should free up, and ``requeue`` is True when the refusal is a
    transient not-admitting signal (drain/stop) rather than overload."""

    __slots__ = ("service", "qos", "arrival", "deadline", "outcome",
                 "jct", "latency", "error", "retry_after", "requeue",
                 "batch_size", "_event")

    def __init__(self, service, qos: str, arrival: float,
                 deadline: Optional[float]):
        self.service = service
        self.qos = qos
        self.arrival = arrival
        self.deadline = deadline       # absolute, plane clock; None = no SLO
        self.outcome: Optional[str] = None
        self.jct: Optional[float] = None
        self.latency: Optional[float] = None   # resolve time - arrival
        self.error: Optional[BaseException] = None
        self.retry_after: Optional[float] = None
        self.requeue = False
        self.batch_size = 0
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Optional[str]:
        """Block until resolved (or ``timeout``); returns the outcome,
        or None when the timeout expired first."""
        self._event.wait(timeout)
        return self.outcome

    def _resolve(self, outcome: str, now: float, jct=None, error=None,
                 retry_after=None, requeue=False) -> None:
        self.outcome = outcome
        self.jct = jct
        self.latency = now - self.arrival
        self.error = error
        self.retry_after = retry_after
        self.requeue = requeue
        self._event.set()

    def __repr__(self):
        return (f"AdmissionTicket({self.qos}, outcome={self.outcome}, "
                f"batch={self.batch_size})")


class _ClassState:
    """Per-class queue + conservation counters + latency samples."""

    __slots__ = ("cls", "queue", "offered", "admitted", "rejected",
                 "shed", "requeued", "completed", "failed", "cancelled",
                 "in_deadline", "latencies")

    def __init__(self, cls: QoSClass):
        self.cls = cls
        self.queue: deque = deque()
        self.offered = 0
        self.admitted = 0      # handed to the engine
        self.rejected = 0      # backpressure (queue full / not admitting)
        self.shed = 0          # deadline unmeetable at dispatch
        self.requeued = 0      # still queued at stop()
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        self.in_deadline = 0   # completed within their SLO budget
        self.latencies: List[float] = []


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[i]


class AdmissionPlane:
    """The admission front-end over one ``ServingSystem``.

    ``system`` only needs ``_invoke_async(service, on_done, deadline=)``
    (and ``invoke`` for the wired-but-disabled fall-through), so tests
    drive the plane against a stub system deterministically.

    ``max_inflight`` bounds concurrently-running task GROUPS (batched
    invocations count once) — the knob that creates queueing, and hence
    backpressure and shedding, under overload. ``dispatcher=False``
    skips the background thread; callers then ``pump()`` manually (the
    deterministic mode the property tests use). ``record_events=True``
    keeps an append-only decision log of (seq, action, class, ...)
    tuples for invariant checking.

    **Conservation invariant** (the plane's load-bearing contract,
    pinned by the property suite and the ``require_conservation`` bench
    gate): every offered request resolves exactly one way, per class —

        offered == admitted + rejected + shed + requeued

    and, once the plane has stopped,

        admitted == completed + failed + cancelled

    No path may drop a ticket silently or resolve it twice; anything
    that admits, rejects, sheds, or requeues MUST bump exactly one
    counter under ``_lock`` and resolve the ticket exactly once.
    ``stats()`` exposes the counters; code that adds a new outcome must
    extend both equations or the conservation checks go red."""

    def __init__(self, system, classes: Sequence[QoSClass] = None,
                 max_inflight: int = 4, clock=time.perf_counter,
                 enabled: bool = True, dispatcher: bool = True,
                 record_events: bool = False, ema_alpha: float = 0.3,
                 backend=None, shard_by: str = "qos"):
        classes = tuple(DEFAULT_CLASSES if classes is None else classes)
        if not classes:
            raise ValueError("AdmissionPlane needs at least one QoSClass")
        names = [c.name for c in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate QoS class names: {names}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if shard_by not in SHARD_ROUTERS:
            raise ValueError(f"unknown shard router {shard_by!r} "
                             f"(have {sorted(SHARD_ROUTERS)})")
        self._system = system
        #: dispatch backend: None routes launches to the in-process
        #: engine (``system._invoke_async``, the default path — kept
        #: bit-identical); an object with ``dispatch(service, on_done,
        #: deadline=, shard=)`` + ``overloaded(shard)`` (e.g.
        #: ``repro_torch.serving.workers.StoreBackend``) persists them for a
        #: worker fleet instead, with per-worker backpressure folded
        #: into admission.
        self._backend = backend
        self._shard_of = SHARD_ROUTERS[shard_by]
        # strict-priority dispatch order: highest QoS (lowest level) first
        self.classes = tuple(sorted(classes,
                                    key=lambda c: (c.priority, c.name)))
        self._states = [_ClassState(c) for c in self.classes]
        self._by_name = {c.cls.name: c for c in self._states}
        self.max_inflight = max_inflight
        self.clock = clock
        self.enabled = enabled
        self.ema_alpha = ema_alpha
        self._ema: Dict[object, float] = {}     # service.key -> EMA JCT (s)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inflight = 0
        self._draining = False
        self._stopping = False
        self._started = False
        self.priority_inversions = 0    # must stay 0: pinned by tests
        self.record_events = record_events
        self.events: List[tuple] = []
        self._event_seq = 0
        self._thread = (threading.Thread(target=self._run, daemon=True,
                                         name="fikit-admission")
                        if (dispatcher and enabled) else None)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "AdmissionPlane":
        if self._thread is not None and not self._started:
            self._thread.start()
        self._started = True
        return self

    def drain(self, timeout: float = 10.0) -> bool:
        """Stop admitting (submits reject with the requeue signal), keep
        dispatching until every queue is empty and nothing is in flight.
        Returns True when fully drained within ``timeout``."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._thread is None:
                self.pump()                      # manual mode drains inline
            with self._lock:
                if self._inflight == 0 and not any(s.queue
                                                   for s in self._states):
                    return True
            time.sleep(0.002)
        return False

    def stop(self) -> None:
        """Stop the dispatcher; tickets still queued resolve REQUEUED (a
        resubmit-later signal, not a failure). Idempotent."""
        with self._cond:
            if self._stopping:
                return
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None and self._started:
            self._thread.join(timeout=5)
        now = self.clock()
        leftovers = []
        with self._lock:
            for st in self._states:
                while st.queue:
                    t = st.queue.popleft()
                    st.requeued += 1
                    self._log("requeue", st.cls.name)
                    leftovers.append(t)
        for t in leftovers:
            t._resolve(REQUEUED, now, requeue=True)

    # --------------------------------------------------------------- intake
    def submit(self, service, qos: str, deadline=_UNSET,
               arrival: Optional[float] = None) -> AdmissionTicket:
        """Offer one invocation of ``service`` under class ``qos``.

        Returns immediately with a ticket: queued for dispatch, or
        already resolved REJECTED (queue full -> ``retry_after`` hint;
        draining/stopped -> ``requeue=True``). ``deadline`` overrides
        the class's default SLO budget (relative seconds; None = no
        deadline); ``arrival`` backdates the offered time (trace
        replay)."""
        try:
            st = self._by_name[qos]
        except KeyError:
            raise ValueError(f"unknown QoS class {qos!r} "
                             f"(have {sorted(self._by_name)})") from None
        now = self.clock() if arrival is None else arrival
        rel = st.cls.deadline if deadline is _UNSET else deadline
        abs_deadline = None if rel is None else now + rel
        t = AdmissionTicket(service, st.cls.name, now, abs_deadline)
        if not self.enabled:
            return self._submit_passthrough(st, t, rel)
        retry = (None if self._backend is None else
                 self._backend.overloaded(self._shard_of(service,
                                                         st.cls.name)))
        with self._cond:
            st.offered += 1
            if self._stopping or self._draining:
                st.rejected += 1
                self._log("reject", st.cls.name, "not-admitting")
                t._resolve(REJECTED, self.clock(), requeue=True)
            elif retry is not None:
                # per-worker backpressure: the backend's claimable
                # backlog already exceeds the live fleet's budget
                st.rejected += 1
                self._log("reject", st.cls.name, "backend-overloaded")
                t._resolve(REJECTED, self.clock(), retry_after=retry)
            elif len(st.queue) >= st.cls.queue_limit:
                st.rejected += 1
                self._log("reject", st.cls.name, "queue-full")
                t._resolve(REJECTED, self.clock(),
                           retry_after=self._retry_after(st))
            else:
                st.queue.append(t)
                self._cond.notify_all()
        return t

    def _submit_passthrough(self, st: _ClassState, t: AdmissionTicket,
                            rel: Optional[float]) -> AdmissionTicket:
        """Wired-but-disabled: the direct blocking ``invoke`` path, so
        the engine sees EXACTLY the no-plane call sequence (the trace
        differential contract). Only counters differ — and they live in
        the plane, not the engine."""
        with self._lock:
            st.offered += 1
            st.admitted += 1
        try:
            jcts = self._system.invoke(t.service, n=1, deadline=rel)
        except BaseException as e:
            with self._lock:
                st.failed += 1
            t._resolve(FAILED, self.clock(), error=e)
            return t
        now = self.clock()
        with self._lock:
            if jcts:
                st.completed += 1
                st.latencies.append(now - t.arrival)
                if t.deadline is None or now <= t.deadline:
                    st.in_deadline += 1
            else:
                st.cancelled += 1
        t._resolve(COMPLETED if jcts else CANCELLED, now,
                   jct=jcts[0] if jcts else None)
        return t

    def _retry_after(self, st: _ClassState) -> Optional[float]:
        """Backpressure hint: rough seconds until this class's queue
        should have space, from the observed service-time EMA."""
        ema = self._ema.get(getattr(st.queue[0].service, "key", None)) \
            if st.queue else None
        if ema is None and self._ema:
            ema = sum(self._ema.values()) / len(self._ema)
        if ema is None:
            return None
        groups = max(1, len(st.queue) // st.cls.max_batch)
        return groups * ema / self.max_inflight

    # ------------------------------------------------------------- dispatch
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._stopping and not self._work_ready():
                    self._cond.wait(timeout=0.05)
                if self._stopping:
                    return
                groups = self._collect_groups()
            for st, members in groups:
                self._launch_group(st, members)

    def pump(self) -> int:
        """Manual dispatch (no dispatcher thread): run passes until no
        group launches; returns how many invocations were admitted.
        Deterministic — the property tests' entry point."""
        admitted = 0
        while True:
            with self._lock:
                groups = self._collect_groups()
            if not groups:
                return admitted
            for st, members in groups:
                admitted += len(members)
                self._launch_group(st, members)

    def _work_ready(self) -> bool:
        return (self._inflight < self.max_inflight
                and any(s.queue for s in self._states))

    def _collect_groups(self):
        """One strict-priority dispatch pass (lock held): pop batches
        from the highest non-empty class, shedding hopeless members,
        until the in-flight cap is reached. Returns launchable groups."""
        groups = []
        while self._inflight < self.max_inflight:
            st = next((s for s in self._states if s.queue), None)
            if st is None:
                break
            higher_queued = 0
            for s in self._states:
                if s is st:
                    break
                higher_queued += len(s.queue)
            now = self.clock()
            head = st.queue[0]
            members: List[AdmissionTicket] = []
            sheds: List[AdmissionTicket] = []
            while (st.queue and len(members) < st.cls.max_batch
                   and st.queue[0].service is head.service):
                t = st.queue.popleft()
                if self._hopeless(t, now):
                    st.shed += 1
                    self._log("shed", st.cls.name, "deadline-unmeetable",
                              higher_queued)
                    sheds.append(t)
                else:
                    members.append(t)
            for t in sheds:
                t._resolve(SHED, now)
            if not members:
                continue                     # everything popped was shed
            if higher_queued:                # structurally impossible:
                self.priority_inversions += 1   # strict-priority scan
            st.admitted += len(members)
            self._inflight += 1
            for t in members:
                t.batch_size = len(members)
            self._log("admit", st.cls.name, len(members), higher_queued)
            groups.append((st, members))
        return groups

    def _hopeless(self, t: AdmissionTicket, now: float) -> bool:
        """SLO-aware shed rule: the EDF budget is already unmeetable.
        Cold services (no observed JCT yet) are never shed."""
        if t.deadline is None:
            return False
        predicted = self._ema.get(getattr(t.service, "key", None))
        if predicted is None:
            return False
        return now + predicted > t.deadline

    def _launch_group(self, st: _ClassState, members) -> None:
        """Hand one coalesced group to the engine as a single task
        stream; the earliest member deadline governs EDF ordering."""
        deadlines = [t.deadline for t in members if t.deadline is not None]
        rel = None
        if deadlines:
            rel = max(0.0, min(deadlines) - self.clock())
        def cb(jct, error):
            self._group_done(st, members, jct, error)
        if self._backend is not None:
            self._backend.dispatch(
                members[0].service, cb, deadline=rel,
                shard=self._shard_of(members[0].service, st.cls.name))
        else:
            self._system._invoke_async(members[0].service, cb,
                                       deadline=rel)

    def _group_done(self, st: _ClassState, members, jct, error) -> None:
        """Completion callback (device thread, no engine lock): resolve
        every member ticket, learn the service-time EMA, free the
        in-flight slot, wake the dispatcher."""
        now = self.clock()
        key = getattr(members[0].service, "key", None)
        with self._cond:
            self._inflight -= 1
            for t in members:
                if error is None and jct is not None:
                    st.completed += 1
                    st.latencies.append(now - t.arrival)
                    if t.deadline is None or now <= t.deadline:
                        st.in_deadline += 1
                elif jct is None and error is None:
                    st.cancelled += 1
                else:
                    st.failed += 1
            if jct is not None and key is not None:
                prev = self._ema.get(key)
                self._ema[key] = (jct if prev is None else
                                  self.ema_alpha * jct
                                  + (1 - self.ema_alpha) * prev)
            self._cond.notify_all()
        for t in members:
            if error is None and jct is not None:
                t._resolve(COMPLETED, now, jct=jct)
            elif jct is None and error is None:
                t._resolve(CANCELLED, now)
            else:
                t._resolve(FAILED, now, error=error)

    # ---------------------------------------------------------------- intro
    def note_latency(self, service, jct: float) -> None:
        """Prime (or update) the service-time EMA — e.g. from the
        measurement phase's exclusive JCTs, so shedding is SLO-aware
        from the first sharing-phase request."""
        key = getattr(service, "key", None)
        if key is None:
            return
        with self._lock:
            prev = self._ema.get(key)
            self._ema[key] = (jct if prev is None else
                              self.ema_alpha * jct
                              + (1 - self.ema_alpha) * prev)

    def predicted_jct(self, service) -> Optional[float]:
        with self._lock:
            return self._ema.get(getattr(service, "key", None))

    def _log(self, action: str, cls: str, *detail) -> None:
        if self.record_events:
            self.events.append((self._event_seq, action, cls) + detail)
            self._event_seq += 1

    def stats(self) -> dict:
        """Per-class conservation counters + latency percentiles +
        goodput, plus the plane-wide invariant counters."""
        with self._lock:
            out = {
                "enabled": self.enabled,
                "inflight": self._inflight,
                "priority_inversions": self.priority_inversions,
                "classes": {},
            }
            for st in self._states:
                lat = sorted(st.latencies)
                offered = st.offered
                out["classes"][st.cls.name] = {
                    "priority": st.cls.priority,
                    "offered": offered,
                    "admitted": st.admitted,
                    "rejected": st.rejected,
                    "shed": st.shed,
                    "requeued": st.requeued,
                    "completed": st.completed,
                    "failed": st.failed,
                    "cancelled": st.cancelled,
                    "queued": len(st.queue),
                    "p50_ms": 1e3 * _percentile(lat, 0.50),
                    "p99_ms": 1e3 * _percentile(lat, 0.99),
                    "mean_ms": (1e3 * sum(lat) / len(lat)) if lat else 0.0,
                    "goodput": (st.in_deadline / offered) if offered else 0.0,
                }
            return out


def coerce_admission(spec):
    """Normalize ``ServingSystem(admission=)``: None -> None (plane
    absent, the pre-admission serving system), True -> default classes,
    a QoSClass sequence -> those classes, a dict -> ``AdmissionPlane``
    kwargs (``classes``/``max_inflight``/``enabled``/...). Returns the
    kwargs dict for the plane constructor, or None."""
    if spec is None:
        return None
    if spec is True:
        return {}
    if isinstance(spec, QoSClass):
        return {"classes": (spec,)}
    if isinstance(spec, dict):
        return dict(spec)
    if isinstance(spec, (list, tuple)):
        return {"classes": tuple(spec)}
    raise TypeError(f"admission= expects None/True/QoSClass(es)/dict, "
                    f"got {spec!r}")
