"""Tasks, task keys and kernel requests (paper §3.2).

A *task* is one invocation of a service (e.g. one inference). A task's GPU
work is a sequence of kernels; between consecutive kernels the device idles
for the task's host-side "gap". ``TaskKey`` is the paper's unique task
identifier (process name + startup parameters) keying the profiled data.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from repro_torch.core.kernel_id import KernelID

NUM_PRIORITIES = 10


class Priority(int):
    """0 = highest, 9 = lowest (paper Fig 7)."""

    def __new__(cls, v: int):
        if not 0 <= int(v) < NUM_PRIORITIES:
            raise ValueError(f"priority must be in [0, {NUM_PRIORITIES})")
        return super().__new__(cls, v)


@dataclass(frozen=True)
class TaskKey:
    """Paper: 'According to the process name and startup parameters of the
    task, the Task Key is generated as the unique identifier of the task.'"""
    process: str
    args: Tuple = ()

    def encode(self) -> str:
        return f"{self.process}|{self.args}"


@dataclass(frozen=True)
class TraceKernel:
    """One kernel occurrence in a task trace: duration + following host gap
    (both seconds). Used by the simulator and as ground truth in tests.

    ``kclass`` is the kernel's ground-truth resource class
    (``repro_torch.core.interference``: "compute" / "memory"), recorded into the
    profile by the measurement phase and used by the simulator's physical
    interference environment. ``None`` (default) means unclassified,
    treated as compute-bound everywhere."""
    kid: KernelID
    duration: float
    gap_after: float = 0.0
    kclass: Optional[str] = None


_req_counter = itertools.count()


@dataclass
class KernelRequest:
    """A kernel launch request traveling hook-client -> scheduler (paper's
    UDP message).

    ``deadline`` is an optional absolute completion deadline (same clock as
    the driving engine: virtual seconds in the simulator, ``perf_counter``
    seconds in the wall-clock engine) carried from the owning task. It is
    only consulted by ``edf``-disciplined priority-queue levels; requests
    without a deadline sort after every dated request and keep FIFO order
    among themselves."""
    task_key: TaskKey
    kernel_id: KernelID
    priority: int
    task_instance: int = 0        # which running task instance
    seq_index: int = 0            # kernel index within the task
    submit_time: float = 0.0
    payload: Any = None           # sim: true duration | wallclock: callable
    deadline: Optional[float] = None
    uid: int = field(default_factory=lambda: next(_req_counter))

    def __repr__(self):
        return (f"KernelRequest({self.task_key.process}#{self.task_instance}"
                f" k{self.seq_index} prio={self.priority})")


@dataclass
class TaskSpec:
    """A runnable task: its key, priority and kernel trace.

    max_inflight models the client's launch-ahead: 1 = synchronous client
    (issues kernel i+1 only after observing kernel i's completion plus its
    host gap); m > 1 = CUDA-style async client that keeps up to m kernels
    in flight, issuing launch i+1 a host-gap after launch i. Device-bound
    tasks with large m are what inflate a high-priority co-tenant's JCT in
    default sharing mode (paper Fig 2 "A,B Sharing 1").
    """
    key: TaskKey
    priority: int
    kernels: List[TraceKernel]
    arrival: float = 0.0
    max_inflight: int = 1
    #: optional absolute completion deadline (sim seconds). Tagged onto
    #: every kernel request of the task; drives ``edf`` queue levels and
    #: the ``SimReport.deadline_misses`` counter.
    deadline: Optional[float] = None

    @property
    def solo_jct(self) -> float:
        """JCT when running exclusively (kernels + internal gaps)."""
        if not self.kernels:
            return 0.0
        total = sum(k.duration + k.gap_after for k in self.kernels)
        return total - self.kernels[-1].gap_after
