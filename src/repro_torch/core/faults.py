"""Fault injection for the scheduling engines.

A ``FaultPlan`` scripts what goes wrong — and when — against the one
place failures are observable and recoverable: the KERNEL BOUNDARY.
Kernels are non-preemptible (a launched kernel always finishes), so every
durable-state transition in the ops plane (``repro_torch.core.jobstore``)
happens between kernels; a crash injected anywhere else would model a
failure mode the scheduler is not (and per the paper cannot be)
responsible for surviving mid-kernel.

Boundaries are counted globally across the run: boundary ``i`` is the
completion processing of the i-th kernel (0-based) to finish on any
device. At each boundary the driving engine asks the plan what to do:

- ``controls[i]`` — a list of lifecycle verbs to apply first:
  ``("cancel", instance)``, ``("pause", instance)``,
  ``("resume", instance)`` or ``("resume", instance, device)``. These
  drive the placement layer's lifecycle seam deterministically, which is
  how the cancellation-conservation property tests script verb storms.
- ``crash_at == i`` — the process dies at this boundary, AFTER the job
  store has durably recorded the completion (the write-ahead contract:
  the completion record is the boundary's commit point). ``hard=True``
  calls ``os._exit(CRASH_EXIT)`` — no exception handlers, no atexit, no
  buffered-IO flush, the closest in-process stand-in for SIGKILL — for
  subprocess kill-and-restart tests. ``hard=False`` raises
  ``InjectedCrash`` so a test can sweep every boundary in-process and
  then re-open the store file cold, proving the same durability without
  a process spawn per crash point.

A plan with no crash point and no controls is inert: the engines consult
it but never act, and decision traces stay bit-identical to a run with no
plan at all (pinned by the wired-but-disabled differential cases in
``tests/test_recovery.py``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: exit status of a hard injected crash — distinguishable from python
#: tracebacks (1) and signal deaths (<0 from subprocess's perspective)
CRASH_EXIT = 86


class InjectedCrash(RuntimeError):
    """Raised by a soft ``FaultPlan`` crash: the simulated process death.

    Carries the boundary index it fired at, so sweep tests can assert the
    crash happened where it was scripted."""

    def __init__(self, boundary: int):
        super().__init__(f"injected crash at kernel boundary {boundary}")
        self.boundary = boundary


@dataclass
class FaultPlan:
    """Scripted faults/verbs keyed by global kernel-boundary index.

    ``crash_at=None`` with empty ``controls`` is the inert wired-but-
    disabled configuration. The plan is single-use: it counts boundaries
    internally (``boundaries_seen``), so build a fresh plan per run."""
    crash_at: Optional[int] = None
    hard: bool = False
    controls: Dict[int, List[Tuple]] = field(default_factory=dict)
    boundaries_seen: int = 0

    @property
    def inert(self) -> bool:
        return self.crash_at is None and not self.controls

    def at_boundary(self) -> Tuple[bool, List[Tuple]]:
        """Advance to the next boundary. Returns ``(crash, verbs)``: the
        verbs to apply at this boundary, and whether the process dies
        after applying them. The engine applies verbs FIRST — a scripted
        cancel-then-crash at one boundary must persist the cancel."""
        i = self.boundaries_seen
        self.boundaries_seen += 1
        return self.crash_at == i, self.controls.get(i, [])

    def crash(self) -> None:
        """Execute the crash decided by ``at_boundary``."""
        boundary = self.boundaries_seen - 1
        if self.hard:
            os._exit(CRASH_EXIT)
        raise InjectedCrash(boundary)
