"""Hook client (paper §3.2): intercepts every GPU-kernel (program segment)
dispatch of a service, constructs the kernel ID in real time, and forwards
the launch request to the FIKIT scheduler.

Paper mechanism: LD_PRELOAD CUDA hook + ``-rdynamic`` symbol recovery + UDP
to the scheduler process. Here: the service's segments are called through
``HookClient.dispatch`` which builds the ``KernelID`` from the segment name
and avals (zero-cost identification — no timing in the sharing stage) and
submits to the in-process ``WallClockEngine``.

Two phases per the paper:
- ``measure_run``: exclusive execution with per-kernel timing
  (block_until_ready bracketing, the cudaEvent analog) feeding a Profiler —
  this is the expensive measurement stage.
- ``run``: the FIKIT sharing stage — identification only, scheduler decides
  placement; the client never times anything.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Optional, Sequence, Tuple

from repro_torch.core.executor import WallClockEngine
from repro_torch.core.kernel_id import KernelID, kernel_id_for
from repro_torch.core.profiler import Profiler
from repro_torch.core.task import KernelRequest, TaskKey

_instances = itertools.count(1)


def new_instance() -> int:
    """Allocate a fresh, process-unique task instance id. The serving
    layer allocates one AHEAD of ``HookClient.run(instance=...)`` so it
    can map the instance to its durable job record (and target it with
    lifecycle verbs) before the first engine event fires."""
    return next(_instances)


class Segment:
    """One dispatchable unit of a service: name + callable(state) -> state.

    ``host_work`` is the host-side post-processing attributable to this
    segment (sampling, detokenization, batching bookkeeping...) executed by
    the client AFTER the segment's result is available — the origin of the
    inter-kernel gap."""

    def __init__(self, name: str, fn: Callable, host_work: Optional[Callable] = None):
        self.name = name
        self.fn = fn
        self.host_work = host_work

    def kernel_id(self, state) -> KernelID:
        ins = state if isinstance(state, (tuple, list)) else (state,)
        return kernel_id_for(self.name, inputs=[x for x in ins
                                                if hasattr(x, "shape")])


class HookClient:
    def __init__(self, engine: WallClockEngine, key: TaskKey, priority: int,
                 segments: Sequence[Segment], identify: bool = True):
        self.engine = engine
        self.key = key
        self.priority = priority
        self.segments = list(segments)
        self.identify = identify   # off = "base" env (no kernel-ID hook)

    # ------------------------------------------------------------- sharing
    def run(self, state, deadline: Optional[float] = None,
            instance: Optional[int] = None) -> Tuple[object, float]:
        """Execute one task (all segments) under the scheduler. Returns
        (final_state, wall JCT).

        ``deadline`` is a completion budget in seconds RELATIVE to this
        call; it is converted to the engine's absolute clock
        (``perf_counter``) and tagged onto every kernel request, where
        ``edf``-disciplined queue levels order by it. The caller judges a
        miss by comparing the returned JCT against the budget.

        ``instance`` pins the task instance id (from ``new_instance()``)
        so callers can target the run with lifecycle verbs; default is a
        fresh id."""
        inst = next(_instances) if instance is None else instance
        t_begin = time.perf_counter()
        abs_deadline = None if deadline is None else t_begin + deadline
        self.engine.task_begin(inst, self.key, self.priority)
        try:
            for i, seg in enumerate(self.segments):
                kid = (seg.kernel_id(state) if self.identify
                       else KernelID(seg.name))
                req = KernelRequest(task_key=self.key, kernel_id=kid,
                                    priority=self.priority,
                                    task_instance=inst, seq_index=i,
                                    payload=_bind(seg.fn, state),
                                    deadline=abs_deadline)
                fut = self.engine.submit(req)
                state, _, _ = fut.result()
                if seg.host_work is not None:
                    state = seg.host_work(state)
        finally:
            self.engine.task_end(inst)
        return state, time.perf_counter() - t_begin

    # -------------------------------------------------------------- async
    def run_async(self, state, on_done, deadline: Optional[float] = None,
                  instance: Optional[int] = None) -> int:
        """Non-blocking counterpart of ``run``: execute one task (all
        segments) by chaining the engine's completion callbacks instead
        of parking this thread on a Future per kernel. Returns the task
        instance id immediately; ``on_done(final_state, jct, error)``
        fires exactly once from a device thread (no engine lock held)
        when the task retires — ``error`` is the first exception
        (``JobCancelled`` for an ops-plane cancel, the payload's own
        exception otherwise) and ``final_state`` is None on error.

        This is the admission plane's submit path: one dispatcher thread
        can keep hundreds of invocations in flight because nothing here
        ever blocks (EXCLUSIVE mode is the exception — its ``task_begin``
        admission wait still parks the caller)."""
        inst = next(_instances) if instance is None else instance
        t_begin = time.perf_counter()
        abs_deadline = None if deadline is None else t_begin + deadline
        segments = self.segments
        self.engine.task_begin(inst, self.key, self.priority)

        def finish(result, error) -> None:
            self.engine.task_end(inst)
            on_done(result, time.perf_counter() - t_begin, error)

        def step(i: int, state) -> None:
            seg = segments[i]
            kid = (seg.kernel_id(state) if self.identify
                   else KernelID(seg.name))
            req = KernelRequest(task_key=self.key, kernel_id=kid,
                                priority=self.priority,
                                task_instance=inst, seq_index=i,
                                payload=_bind(seg.fn, state),
                                deadline=abs_deadline)

            def completed(req, out, t0, t1, err) -> None:
                if err is not None:
                    finish(None, err)
                    return
                try:
                    if seg.host_work is not None:
                        out = seg.host_work(out)
                    if i + 1 < len(segments):
                        step(i + 1, out)
                    else:
                        finish(out, None)
                except BaseException as e:   # host_work / next-submit fail
                    finish(None, e)

            self.engine.submit(req, on_complete=completed)

        try:
            step(0, state)
        except BaseException as e:     # first submit failed synchronously
            finish(None, e)
        return inst

    # ----------------------------------------------------------- measurement
    def measure_run(self, state, profiler: Profiler) -> Tuple[object, float]:
        """One exclusive measured run (paper Fig 6): per-kernel duration via
        device-side bracketing + inter-kernel gap via launch timestamps."""
        inst = next(_instances)
        t_begin = time.perf_counter()
        self.engine.task_begin(inst, self.key, self.priority)
        profiler.start_run()
        last_end: Optional[float] = None
        try:
            for i, seg in enumerate(self.segments):
                kid = seg.kernel_id(state)
                req = KernelRequest(task_key=self.key, kernel_id=kid,
                                    priority=self.priority,
                                    task_instance=inst, seq_index=i,
                                    payload=_bind(seg.fn, state))
                fut = self.engine.submit(req)
                state, k_start, k_end = fut.result()
                if last_end is not None:
                    profiler.record_gap(max(0.0, k_start - last_end))
                profiler.record(kid, k_end - k_start)
                last_end = k_end
                if seg.host_work is not None:
                    state = seg.host_work(state)
        finally:
            profiler.end_run()
            self.engine.task_end(inst)
        return state, time.perf_counter() - t_begin


def _bind(fn, state):
    def call():
        return fn(state)
    return call
