"""Algorithm 1 (FIKIT Procedure) and Algorithm 2 (BestPrioFit) — the
paper's pseudocode (Figs 9 and 10), with BestPrioFit served from the
indexed priority queues in O(log n) per decision.

Semantics preserved exactly (and enforced by the differential tests in
``tests/test_policy_differential.py`` against ``best_prio_fit_scan``):
- BestPrioFit scans priorities 0..9; at the FIRST priority level containing
  any fitting kernel it selects the kernel with the LONGEST predicted
  duration that still fits the remaining idle time
  (``bestKernelTime < predictedKernelTime < idleTime``), dequeues it and
  returns it. Lower priority levels are not examined once a fit is found.
  Ties on predicted duration resolve to the earliest-parked request, as in
  the scan's first-seen-wins FIFO walk.
- FIKIT looks up the predicted gap from profiled SG when idleTime == -1,
  skips gaps <= EPSILON (paper: 0.1 ms — a kernel launch costs 0.1-2 ms),
  then repeatedly calls BestPrioFit, launching every selected kernel and
  decrementing the remaining idle time, until nothing fits.

One deviation from the paper's pseudocode (both implementations): within a
single task instance (one CUDA stream) only the OLDEST queued kernel is
eligible. A stream's kernels execute in issue order, so selecting kernel
i+1 as a filler while kernel i is still parked would reorder the stream —
and let a task retire with orphaned requests stuck in the queues.

Queue disciplines: when a ``PriorityQueues`` level is configured ``sjf``
or ``edf`` (see ``repro_torch.core.queues``), the fill selection at that level
changes — SJF picks the SHORTEST profiled fitting head, EDF keeps the
longest-fit criterion but breaks predicted-duration ties to the earliest
deadline. Both ``best_prio_fit`` (indexed) and ``best_prio_fit_scan``
(O(n) oracle) implement every discipline; the default all-``fifo``
configuration is the paper's Algorithm 2, bit-identical to the
pre-discipline implementation.
"""
from __future__ import annotations

import math

from typing import Callable, List, Optional, Tuple

from repro_torch.core.profiler import ProfiledData
from repro_torch.core.queues import PriorityQueues
from repro_torch.core.task import KernelRequest, TaskKey
from repro_torch.core.kernel_id import KernelID

EPSILON = 1.0e-4  # 0.1 ms, paper §3.2 line 6-8 commentary


def best_prio_fit(queues: PriorityQueues, idle_time: float,
                  profiled: ProfiledData, *,
                  holder_class: Optional[str] = None,
                  interference=None,
                  ) -> Tuple[Optional[KernelRequest], float]:
    """Algorithm 2: Sharing Stage Idling Gap Filling Policy.

    Indexed fast path: first non-empty level -> a handful of bisects in
    that level's head index (predecessor search for FIFO/EDF levels,
    successor search for SJF levels). O(levels * log n) per decision
    instead of O(total queued); dequeue of the selected request is
    O(log n) index maintenance.

    ``holder_class`` (with an enabled interference model bound to the
    queues at construction) switches the selection to the
    interference-aware per-class search: a candidate of class ``c`` fits
    only while ``predicted < idle_time / coeff(holder_class, c)``. The
    returned duration stays the RAW prediction; the caller debits the gap
    by the coefficient-scaled effective duration. ``interference`` is
    accepted for signature parity with the scan oracle (the indexed side
    uses the model bound to ``queues``; callers pass the same object to
    both). With ``holder_class=None`` (the default, and always when
    interference is off) the selection is bit-identical to the
    pre-interference implementation.

    Oracle contract: ``best_prio_fit_scan`` is the O(n) reference with
    IDENTICAL selection semantics for every queue discipline and either
    interference setting — same request, same returned duration, for any
    queue state. The randomized differential suite in
    ``tests/test_policy_differential.py`` pins the two trace-identical;
    extend that suite whenever either side changes.
    """
    with queues.lock():
        queues.ensure_index(profiled)
        req, dur = queues.best_fit_under(idle_time,
                                         holder_class=holder_class)
        if req is not None:
            queues.remove(req)
    return req, dur


def best_prio_fit_scan(queues: PriorityQueues, idle_time: float,
                       profiled: ProfiledData, *,
                       holder_class: Optional[str] = None,
                       interference=None,
                       ) -> Tuple[Optional[KernelRequest], float]:
    """Reference oracle: the O(total queued) linear scan.

    The FIFO branch is the original implementation kept verbatim
    (first-seen-wins FIFO walk, ``best > 0`` level-stop rule); the SJF and
    EDF branches define those disciplines' selection semantics the same
    way — by a plain scan over the level's FIFO snapshot, no index. The
    differential tests assert the indexed fast path makes bit-identical
    decisions against this function; never used on the hot path.

    Interference-aware selection (``holder_class`` + an enabled
    ``interference`` model) only tightens each head's fit bound from
    ``idle_time`` to ``idle_time / coeff(holder_class, head_class)``; the
    selection and tie rules are untouched, and with it off ``limit`` is
    exactly ``idle_time``, keeping the scan character-for-character the
    original comparisons."""
    iron = (interference is not None and interference.enabled
            and holder_class is not None)
    best_kernel_time = -1.0
    best_kernel_req: Optional[KernelRequest] = None
    with queues.lock():
        seen_streams = set()
        for priority in range(queues.levels):          # highest -> lowest
            discipline = queues.discipline_of(priority)
            if discipline == "fifo":
                for kernel_req in queues[priority]:    # FIFO within a level
                    stream = (kernel_req.task_key, kernel_req.task_instance)
                    if stream in seen_streams:
                        continue                       # not head-of-stream
                    seen_streams.add(stream)
                    task_key = kernel_req.task_key
                    kernel_id = kernel_req.kernel_id
                    predicted = profiled.predict_duration(task_key,
                                                          kernel_id)
                    limit = idle_time
                    if iron:
                        limit = idle_time / interference.coeff(
                            holder_class,
                            profiled.predict_class(task_key, kernel_id))
                    if best_kernel_time < predicted < limit:
                        best_kernel_time = predicted
                        best_kernel_req = kernel_req
                if best_kernel_time > 0:
                    break      # longest fit found at this priority level
                continue
            # SJF/EDF: the first level holding any profiled fitting head
            # claims the decision; its candidate replaces a carried best
            # only if strictly longer (the same strictly-better rule the
            # FIFO branch applies across levels).
            cand_req = None
            cand_time = -1.0
            cand_dl = math.inf
            for kernel_req in queues[priority]:        # FIFO walk: seq asc
                stream = (kernel_req.task_key, kernel_req.task_instance)
                if stream in seen_streams:
                    continue                           # not head-of-stream
                seen_streams.add(stream)
                predicted = profiled.predict_duration(kernel_req.task_key,
                                                      kernel_req.kernel_id)
                limit = idle_time
                if iron:
                    limit = idle_time / interference.coeff(
                        holder_class,
                        profiled.predict_class(kernel_req.task_key,
                                               kernel_req.kernel_id))
                if not (-1.0 < predicted < limit):
                    continue                           # unprofiled / no fit
                if discipline == "sjf":
                    # shortest fitting; first-seen-wins keeps FIFO ties
                    if cand_req is None or predicted < cand_time:
                        cand_req, cand_time = kernel_req, predicted
                else:  # edf: longest fitting, deadline tie-break
                    dl = (kernel_req.deadline
                          if kernel_req.deadline is not None else math.inf)
                    if cand_req is None or predicted > cand_time or \
                            (predicted == cand_time and dl < cand_dl):
                        cand_req, cand_time, cand_dl = \
                            kernel_req, predicted, dl
            if cand_req is not None:
                if cand_time > best_kernel_time:
                    best_kernel_req = cand_req
                    best_kernel_time = cand_time
                break                       # this level claims the decision
        if best_kernel_req is not None:
            queues.remove(best_kernel_req)
    return best_kernel_req, best_kernel_time


def fikit_procedure(queues: PriorityQueues, task_key: TaskKey,
                    kernel_id: KernelID, idle_time: float,
                    profiled: ProfiledData,
                    launch: Callable[[KernelRequest], None],
                    epsilon: float = EPSILON,
                    remaining_gap: Optional[Callable[[], float]] = None,
                    ) -> List[KernelRequest]:
    """Algorithm 1: FIKIT Procedure.

    ``launch`` sends the selected kernel request to the GPU device queue.
    ``remaining_gap`` is the real-time feedback hook (Fig 12): when given,
    it returns the currently-known remaining idle time (0 once the next
    high-priority kernel has actually arrived); the fill loop re-reads it
    before each selection so prediction error does not propagate.

    Returns the list of launched filler requests.
    """
    launched: List[KernelRequest] = []
    if idle_time == -1:
        idle_time = profiled.predict_gap(task_key, kernel_id)
    if idle_time <= epsilon:                      # skip small gaps
        return launched
    while idle_time > 0.0:
        if remaining_gap is not None:
            idle_time = min(idle_time, remaining_gap())
            if idle_time <= 0.0:
                break                             # early stop (feedback)
        fill_req, fill_time = best_prio_fit(queues, idle_time, profiled)
        if fill_time == -1:
            break
        launch(fill_req)
        launched.append(fill_req)
        idle_time -= fill_time
    return launched
