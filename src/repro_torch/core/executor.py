"""Wall-clock FIKIT engine: real threads, real JAX program execution.

Roles map 1:1 to the paper's deployment (§3.2):
- ``HookClient``   (repro_torch.core.client) — intercepts a service's segment
  dispatches, forwards KernelRequests to the scheduler (paper: LD_PRELOAD
  hook + UDP; here: in-process call + thread-safe queues).
- ``WallClockEngine`` — the FIKIT scheduler process: the serial device
  executor thread (the TPU/GPU analog: one program at a time, FIFO) plus
  the thread-safe shell around the shared scheduling core.

ALL scheduling decisions — holder election, routing, gap open/close with
real-time feedback, the bounded BestPrioFit fill loop, release-on-task-done,
overshoot accounting, PREEMPT parking — live in
``repro_torch.core.policy.FikitPolicy``, the same state machine that drives the
discrete-event simulator; device election and cross-device work stealing
live in ``repro_torch.core.placement.PlacementLayer`` (K=1 is a pass-through).
This engine only adds what the simulator fakes: real threads, a lock,
Futures, and ``time.perf_counter``.

Each device thread pops launched requests in FIFO order and runs their
payload callables (jitted JAX segments, block_until_ready inside).
``devices=K`` starts K device threads over K serial queues, one per
placement device. Everything the simulator models is real here: device
busy intervals, queue waits, fill overshoot.

CAVEAT for K > 1: a "device" is a serial executor THREAD. Payloads are
not pinned to distinct JAX devices, so on a single-accelerator host the K
serial queues share one piece of hardware and wall-clock multi-device
numbers measure scheduling behavior (routing, parking, stealing), not
hardware scaling — use the discrete-event simulator
(``SimScheduler(devices=K)``, ``benchmarks/bench_placement.py``) for
scaling claims. On a multi-device host, pin each payload to
``jax.devices()[d]`` (e.g. ``jax.device_put``/``jit(device=...)``) to
make thread d's queue correspond to real hardware d.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.fikit import EPSILON
from repro_torch.core.interference import InterferenceModel
from repro_torch.core.online import OnlineConfig, OnlineMeasurement
from repro_torch.core.placement import DisciplineSpec, PlacementLayer
from repro_torch.core.policy import Mode
from repro_torch.core.profiler import ProfiledData
from repro_torch.core.task import KernelRequest, TaskKey


@dataclass
class ExecRecord:
    req: KernelRequest
    start: float
    end: float
    filler: bool = False
    device: int = 0


class JobCancelled(RuntimeError):
    """Set on the Future of every request purged by an ops-plane cancel
    (and returned for submits arriving after the cancel), so a client
    blocked on ``fut.result()`` unblocks with a typed error instead of
    hanging forever."""


class WallClockEngine:
    def __init__(self, mode: Mode = Mode.FIKIT,
                 profiled: Optional[ProfiledData] = None,
                 pipeline_depth: int = 2, feedback: bool = True,
                 epsilon: float = EPSILON, trace: str = "list",
                 devices: int = 1,
                 discipline: DisciplineSpec = "least_loaded",
                 queue_discipline="fifo",
                 steal: bool = True,
                 online=None,
                 interference=None,
                 on_kernel_complete=None):
        """queue_discipline selects the per-level intra-device queue
        ordering ("fifo" default / "sjf" / "edf"); request deadlines for
        edf levels are absolute ``time.perf_counter`` seconds (the
        engine's clock), which ``HookClient.run(deadline=...)`` derives
        from a caller-relative budget.

        online (None / True / repro_torch.core.online.OnlineConfig) enables the
        live SK/SG refinement loop: each device thread's perf_counter
        brackets feed the OnlineMeasurement (under the engine lock, like
        every other placement entry point), epoch commits reload the
        shared profile mid-serving, and ``stop()`` flushes the partial
        final epoch. ``online_stats()`` exposes the counters.

        interference (None / True / mapping /
        repro_torch.core.interference.InterferenceModel) enables
        interference-aware gap filling (see ``SimScheduler``); None or a
        disabled model keeps decisions bit-identical to
        interference-off.

        on_kernel_complete (callable ``fn(req, start, end)`` or None) is
        the ops plane's write-ahead seam: called by the device thread
        under the engine lock the moment a kernel finishes, BEFORE any
        scheduling side-effect of the completion, so a durable record
        (``repro_torch.core.jobstore``) commits ahead of the boundary's
        processing. Exceptions from the hook propagate (a store that
        cannot record must not be silently dropped)."""
        self.mode = mode
        self.profiled = profiled or ProfiledData()
        self.devices = devices
        self.interference = InterferenceModel.coerce(interference)
        if self.interference is not None and self.interference.enabled:
            self.profiled.interference = self.interference
        cfg = OnlineConfig.coerce(online)
        self.online = (OnlineMeasurement(self.profiled, cfg,
                                         clock=time.perf_counter,
                                         interference=self.interference)
                       if cfg is not None else None)

        self._lock = threading.RLock()
        # threaded driver: keep the queue lock; trace="off"/"ring" bounds
        # the per-decision trace cost for long-running serving. The engine
        # lock serializes every placement/policy entry point, exactly as it
        # did for the bare single-device policy.
        self.placement = PlacementLayer(devices, mode, self.profiled,
                                        discipline=discipline, steal=steal,
                                        queue_discipline=queue_discipline,
                                        pipeline_depth=pipeline_depth,
                                        feedback=feedback, epsilon=epsilon,
                                        clock=time.perf_counter,
                                        launch=self._device_launch,
                                        threadsafe=True, trace=trace,
                                        online=self.online,
                                        interference=self.interference)
        # single-device alias kept for callers that inspect decision state
        self.policy = self.placement.policies[0]
        self._device_qs: List["queue.Queue"] = [queue.Queue()
                                               for _ in range(devices)]
        self._records: List[ExecRecord] = []
        self._futures: Dict[int, Future] = {}      # req.uid -> Future
        self._done_cbs: Dict[int, object] = {}     # req.uid -> on_complete
        self._admit_cond = threading.Condition(self._lock)
        self._admitted: set = set()
        self._stop = False
        self._threads = [
            threading.Thread(target=self._device_loop, args=(d,),
                             daemon=True, name=f"fikit-device-{d}")
            for d in range(devices)]
        self._started = False
        self._stopped = False
        self._draining = False
        self._cancelled_insts: set = set()
        self._on_kernel_complete = on_kernel_complete

    # ---------------------------------------------------------------- device
    def start(self) -> "WallClockEngine":
        if self._stopped:
            raise RuntimeError("WallClockEngine cannot restart after "
                               "stop(); build a fresh engine")
        if not self._started:
            self._started = True
            for t in self._threads:
                t.start()
        return self

    def stop(self) -> None:
        """Stop the device threads and flush the final online epoch.
        Idempotent: a second stop() is a no-op (in particular the online
        flush commits exactly once)."""
        if self._stopped:
            return
        self._stopped = True
        self._stop = True
        for q in self._device_qs:
            q.put(None)
        if self._started:
            for t in self._threads:
                t.join(timeout=5)
        if self.online is not None:
            with self._lock:
                self.online.commit()   # flush the partial final epoch

    def _check_running(self, what: str) -> None:
        """Fail fast — a submit into a never-started or stopped engine
        would otherwise hang its client forever on an unserved queue."""
        if not self._started:
            raise RuntimeError(f"{what} before WallClockEngine.start() — "
                               f"no device thread is serving the queue")
        if self._stopped:
            raise RuntimeError(f"{what} after WallClockEngine.stop() — "
                               f"the device threads have exited")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _device_loop(self, device: int) -> None:
        # imported here, not at the top: the rest of this module is a
        # verbatim copy of the JAX package's
        from repro_torch import spans
        dq = self._device_qs[device]
        while True:
            asked = time.perf_counter()
            item = dq.get()
            got = time.perf_counter()
            if item is None or self._stop:
                break
            req, fut, filler = item
            t0 = time.perf_counter()
            out = err = None
            try:
                out = req.payload()
            except BaseException as e:  # pragma: no cover
                err = e
            t1 = time.perf_counter()
            issued = spans.take_issued(t1)
            # the request stays in the record; its input need not
            req.payload = None
            if self._on_kernel_complete is not None:
                # write-ahead: the durable record commits BEFORE the
                # Future resolves (a client blocked on it may retire its
                # job at once, and the record would find no job) and
                # before the boundary's scheduling side-effects
                try:
                    with self._lock:
                        self._on_kernel_complete(req, t0, t1)
                except BaseException as e:
                    fut.set_exception(e)
                    raise
            if err is None:
                fut.set_result((out, t0, t1))
            else:
                fut.set_exception(err)
            with self._lock:
                self._futures.pop(req.uid, None)   # resolved: stop pinning it
                self._records.append(ExecRecord(req, t0, t1, filler, device))
                if filler:
                    self.placement.fill_complete(device)
                self.placement.kernel_end(req.task_instance, req.kernel_id,
                                          start=t0, end=t1)
                cb = self._done_cbs.pop(req.uid, None)
            booked = time.perf_counter()
            if cb is not None:
                # completion callback AFTER the boundary's scheduling
                # side-effects, OUTSIDE the lock: the callee may submit
                # the stream's next request or retire the task without
                # parking a thread on the Future (admission-plane seam)
                cb(req, out, t0, t1, err)
            spans.record((device, req.task_instance, req.seq_index,
                          req.priority, filler, req.kernel_id.name,
                          req.submit_time, asked, got, t0, issued, t1,
                          booked, time.perf_counter()))

    # ----------------------------------------------------------- task control
    def task_begin(self, instance: int, key: TaskKey, priority: int) -> None:
        self._check_running(f"task_begin({instance})")
        if self._draining:
            raise RuntimeError("WallClockEngine is draining — "
                               "not admitting new tasks")
        with self._lock:
            if self.placement.task_begin(instance, key, priority):
                return
            # EXCLUSIVE: the policy parked us; wait for admission in the
            # policy's FIFO begin order.
            while instance not in self._admitted:
                self._admit_cond.wait()
            self._admitted.discard(instance)

    def task_end(self, instance: int) -> None:
        with self._lock:
            self._cancelled_insts.discard(instance)
            admitted = self.placement.task_end(instance)
            if admitted:
                self._admitted.update(admitted)
                self._admit_cond.notify_all()

    # --------------------------------------------------------------- routing
    def submit(self, req: KernelRequest, on_complete=None) -> Future:
        """Hook-client -> scheduler message. Returns a Future of
        (output, start, end).

        ``on_complete`` (``fn(req, out, start, end, err)`` or None) is
        the non-blocking completion seam: the device thread calls it
        AFTER the kernel's ``kernel_end`` scheduling side-effects, with
        no engine lock held, so the callee can chain the stream's next
        submit (or ``task_end``) without a thread ever parking on the
        Future. A request purged by an ops-plane ``cancel`` (or
        submitted after one) gets its callback invoked with
        ``err=JobCancelled`` instead."""
        self._check_running(f"submit({req.task_instance}:{req.seq_index})")
        fut: Future = Future()
        req.submit_time = time.perf_counter()
        cancelled = None
        with self._lock:
            if req.task_instance in self._cancelled_insts:
                # the task was cancelled under this client's feet:
                # fail fast instead of queueing work that can never run
                cancelled = JobCancelled(
                    f"task {req.task_instance} was cancelled")
                fut.set_exception(cancelled)
            else:
                self._futures[req.uid] = fut
                if on_complete is not None:
                    self._done_cbs[req.uid] = on_complete
                self.placement.submit(req)
        if cancelled is not None and on_complete is not None:
            on_complete(req, None, None, None, cancelled)
        return fut

    # ------------------------------------------------------- lifecycle verbs
    def cancel(self, instance: int) -> int:
        """Cancel a task: purge its queued requests (their Futures fail
        with ``JobCancelled`` so blocked clients unblock), let in-flight
        kernels finish. Returns the number of purged requests."""
        cbs = []
        with self._lock:
            purged, admitted = self.placement.cancel(instance)
            self._cancelled_insts.add(instance)
            for r in purged:
                err = JobCancelled(
                    f"task {instance} cancelled: kernel "
                    f"{r.seq_index} purged before launch")
                fut = self._futures.pop(r.uid, None)
                if fut is not None:
                    fut.set_exception(err)
                cb = self._done_cbs.pop(r.uid, None)
                if cb is not None:
                    cbs.append((cb, r, err))
            if admitted:                       # EXCLUSIVE: next waiter
                self._admitted.update(admitted)
                self._admit_cond.notify_all()
        for cb, r, err in cbs:   # outside the lock, like every completion
            cb(r, None, None, None, err)
        return len(purged)

    def pause(self, instance: int) -> bool:
        """Pause a task at its next kernel boundary (True if it took
        effect immediately). Its clients' pending Futures stay unresolved
        — a blocked client simply waits out the pause."""
        with self._lock:
            return self.placement.pause(instance)

    def resume(self, instance: int, device: Optional[int] = None) -> int:
        """Re-admit a paused task (see ``PlacementLayer.resume``)."""
        with self._lock:
            return self.placement.resume(instance, device)

    def drain(self, timeout: float = 10.0) -> bool:
        """Stop admitting new tasks, wait for every live (non-paused)
        task to finish its in-flight and queued work, then flush the
        online epoch. Returns True when fully drained within
        ``timeout`` seconds; the engine is still running either way
        (call ``stop()`` to shut it down)."""
        self._draining = True
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                live = len(self.placement._device_of)
            if live == 0 or time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        if self.online is not None:
            with self._lock:
                self.online.commit()
        return live == 0

    def _device_launch(self, device: int, req: KernelRequest,
                       filler: bool) -> None:
        """Placement launch hook: push onto ``device``'s serial queue.

        Always called with ``_lock`` held (every placement entry point
        is)."""
        fut = self._futures.get(req.uid)
        if fut is None:                            # pragma: no cover
            fut = self._futures[req.uid] = Future()
        self._device_qs[device].put((req, fut, filler))

    # ------------------------------------------------------------------ info
    @property
    def fill_count(self) -> int:
        return self.placement.fill_count

    @property
    def overshoot_time(self) -> float:
        return self.placement.overshoot_time

    @property
    def steal_count(self) -> int:
        return self.placement.steal_count

    def online_stats(self) -> Optional[dict]:
        """Online measurement counters (None when the loop is off or
        wired-but-disabled)."""
        if self.online is None or not self.online.config.enabled:
            return None
        with self._lock:
            return self.online.stats()

    def records(self) -> List[ExecRecord]:
        with self._lock:
            return list(self._records)

    def device_busy_time(self, device: Optional[int] = None) -> float:
        return sum(r.end - r.start for r in self.records()
                   if device is None or r.device == device)
