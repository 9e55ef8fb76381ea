"""Multi-device placement over ``FikitPolicy`` — one priority workload mix
spread across K devices.

FIKIT's kernel-level scheduling (arXiv:2311.10359) is defined per-GPU. In a
cluster there is one mix of prioritized services spread over many devices,
and placement — which device a task lands on — decides QoS as much as the
per-device schedule does (cf. Strait, arXiv:2604.28175). ``PlacementLayer``
adds exactly that layer while keeping every per-device guarantee intact
(cf. Tally, arXiv:2410.07381: the sharing layer must not compromise
per-device isolation):

- It owns K independent ``FikitPolicy`` instances, one per device, each
  with its OWN indexed ``PriorityQueues`` and its own trace sink (the
  per-device decision log rides the policy's existing trace seam — there
  is no second trace mechanism).
- ``task_begin`` routes a new task to a device through a pluggable
  *placement discipline*; every later event of that task (``submit``,
  ``kernel_end``, ``task_end``) follows it to the elected device.
- When a device goes idle while another is backlogged, the layer *steals*
  a fully-parked task: its queued requests leave the source device's
  indexed queues (O(log n) ``remove`` each, in stream order — a steal can
  never reorder a task's stream), the task record migrates
  (``FikitPolicy.detach_task`` / ``attach_task``), and the requests
  re-submit on the destination, where the idle device launches them
  immediately. Only tasks with ZERO kernels in flight are candidates, so
  one task's kernels never run on two devices at once.

- It is the ops plane's lifecycle seam (``cancel`` / ``pause`` /
  ``resume``): all three verbs act at kernel boundaries only (a pause
  with kernels in flight defers to the task's next boundary), ride the
  same ``detach_task``/``attach_task`` mechanism as stealing, and a
  resume is a fresh placement decision — which is how a paused task
  migrates to a different device.

K=1 is a pure pass-through: the single discipline answer is device 0,
stealing is structurally impossible, and the layer adds no trace events —
so a K=1 ``PlacementLayer`` is decision-trace-identical to a bare
``FikitPolicy``. That equivalence is pinned by
``tests/test_placement_differential.py`` and, because both engines now
drive the policy through this layer, by the entire pre-existing
differential suite as well.

Placement disciplines (``discipline=`` ctor arg; a callable plugs in a
custom one):

    "least_loaded"       — device minimizing predicted outstanding SK sum
                           (queued + launched-but-unfinished work), ties to
                           fewest resident tasks, then lowest device id.
    "priority_affinity"  — priority bands map onto the device range
                           (priority * K // NUM_PRIORITIES), so
                           high-priority tasks concentrate on the low
                           devices and bulk work on the high ones.
    "round_robin"        — strict rotation, ignores load.
    callable             — ``fn(layer, instance, key, priority, arrival)
                           -> device index``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Set, Union

from repro_torch.core.fikit import EPSILON
from repro_torch.core.policy import FikitPolicy, Mode, TraceSpec
from repro_torch.core.profiler import ProfiledData
from repro_torch.core.queues import QueueDisciplineSpec
from repro_torch.core.task import NUM_PRIORITIES, KernelRequest, TaskKey


def _least_loaded(layer: "PlacementLayer", instance: int, key: TaskKey,
                  priority: int, arrival: float) -> int:
    return min(range(layer.devices),
               key=lambda d: (layer._load[d], len(layer._instances[d]), d))


def _priority_affinity(layer: "PlacementLayer", instance: int, key: TaskKey,
                       priority: int, arrival: float) -> int:
    return priority * layer.devices // NUM_PRIORITIES


def _round_robin(layer: "PlacementLayer", instance: int, key: TaskKey,
                 priority: int, arrival: float) -> int:
    d = layer._rr
    layer._rr = (d + 1) % layer.devices
    return d


#: The placement-discipline registry: device-election strategies for
#: ``PlacementLayer(discipline=...)``. Each entry is a callable
#: ``fn(layer, instance, key, priority, arrival) -> device index`` in
#: ``range(layer.devices)``.
#:
#: Contract for every discipline (built-in or custom): it MUST return 0
#: when ``layer.devices == 1``. K=1 placement is a pinned pass-through —
#: the entire single-device differential suite runs through the layer, so
#: a discipline that routes anywhere else at K=1 breaks the
#: trace-identity guarantee (and ``task_begin`` rejects out-of-range
#: devices outright). To add a discipline: register it here, then extend
#: ``tests/test_placement_differential.py`` — the randomized invariant
#: sweep rotates through ``sorted(DISCIPLINES)`` automatically, but add a
#: directed test for the discipline's routing property and keep the K=1
#: head-to-head green. Distinct from the per-level QUEUE disciplines
#: (``repro_torch.core.queues.QUEUE_DISCIPLINES``), which order parked requests
#: WITHIN one device's priority levels.
DISCIPLINES: Dict[str, Callable] = {
    "least_loaded": _least_loaded,
    "priority_affinity": _priority_affinity,
    "round_robin": _round_robin,
}

DisciplineSpec = Union[str, Callable]


class PlacementLayer:
    """K per-device ``FikitPolicy`` instances + routing + work stealing.

    Mirrors the single-policy driver API so engines drive it the same way
    they drove a bare policy — only ``fill_complete`` and the ``launch``
    hook gain a device index:

    - ``task_begin(instance, key, priority, arrival=None) -> bool``
    - ``submit(req) -> bool``
    - ``fill_complete(device)``
    - ``kernel_end(instance, kernel_id, *, last=False, actual_gap=None)``
    - ``task_end(instance) -> List[int]``

    ``launch`` is called as ``launch(device, req, filler)``.

    Thread safety follows the policies': the layer itself adds no lock, so
    a threaded engine must serialize calls exactly as it already does for
    a bare policy (the wall-clock engine holds its lock around every
    policy entry point).
    """

    def __init__(self, devices: int, mode: Mode,
                 profiled: Optional[ProfiledData] = None, *,
                 discipline: DisciplineSpec = "least_loaded",
                 queue_discipline: QueueDisciplineSpec = "fifo",
                 steal: bool = True,
                 pipeline_depth: int = 2, feedback: bool = True,
                 epsilon: float = EPSILON,
                 clock: Callable[[], float] = lambda: 0.0,
                 launch: Callable[[int, KernelRequest, bool], None] = None,
                 threadsafe: bool = True,
                 trace: TraceSpec = "list",
                 reference: bool = False,
                 online=None,
                 interference=None):
        if launch is None:
            raise TypeError("PlacementLayer requires a launch hook")
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        self.devices = devices
        self.mode = mode
        self.profiled = profiled or ProfiledData()
        #: optional ``repro_torch.core.online.OnlineMeasurement``: the layer
        #: feeds it every kernel completion (with the observing device, so
        #: observations buffer per device and merge on epoch commit) and
        #: shares it with every per-device policy for gap-drift accounting
        self.online = online
        #: optional ``repro_torch.core.interference.InterferenceModel``, shared
        #: by every per-device policy (one coefficient table per node —
        #: class-pair contention is a property of the hardware, not of a
        #: device index)
        self.interference = interference
        self.steal_enabled = steal and devices > 1
        self._clock = clock
        self._launch_hook = launch
        custom_discipline = callable(discipline)
        if custom_discipline:
            self._discipline = discipline
            self.discipline = getattr(discipline, "__name__", "custom")
        else:
            try:
                self._discipline = DISCIPLINES[discipline]
            except KeyError:
                raise ValueError(
                    f"unknown placement discipline: {discipline!r} "
                    f"(known: {sorted(DISCIPLINES)})") from None
            self.discipline = discipline

        def device_launcher(d: int):
            return lambda req, filler: self._on_launch(d, req, filler)

        # each policy gets its own trace sink: a str/int spec constructs a
        # fresh sink per policy; passing a sink OBJECT shares it across all
        # devices (useful for a merged custom log, surprising otherwise).
        # queue_discipline likewise instantiates per device: every policy
        # owns its own indexed PriorityQueues under the same spec.
        self.queue_discipline = queue_discipline
        self.policies: List[FikitPolicy] = [
            FikitPolicy(mode, self.profiled, pipeline_depth=pipeline_depth,
                        feedback=feedback, epsilon=epsilon, clock=clock,
                        launch=device_launcher(d), threadsafe=threadsafe,
                        trace=trace, discipline=queue_discipline,
                        reference=reference, online=online,
                        interference=interference)
            for d in range(devices)]

        self._device_of: Dict[int, int] = {}
        self._key_of: Dict[int, TaskKey] = {}
        self._instances: List[Set[int]] = [set() for _ in range(devices)]
        self._inflight: Dict[int, int] = {}     # launched, not yet completed
        self._parked: Dict[int, "OrderedDict[int, KernelRequest]"] = {}
        # instances with zero kernels in flight and >= 1 parked request —
        # the steal candidates, maintained O(1) at every flight/park
        # transition so an idle device's steal probe never rescans tasks
        self._stealable: Set[int] = set()
        self._retired: Set[int] = set()
        self._load: List[float] = [0.0] * devices   # predicted SK backlog
        self._rr = 0
        # _load only feeds least_loaded election; custom callables may read
        # layer.predicted_load(), so they keep the bookkeeping too
        self._needs_load = (devices > 1
                            and (self._discipline is _least_loaded
                                 or custom_discipline))
        self.steal_count = 0
        self.spurious_kernel_completions = 0
        self.spurious_task_ends = 0
        # ops-plane lifecycle state (cancel/pause/resume — all applied at
        # kernel boundaries only; kernels are non-preemptible)
        self._paused: Dict[int, tuple] = {}      # inst -> (ActiveTask, reqs)
        self._pause_pending: Set[int] = set()    # awaiting in-flight drain
        self._cancelled: Set[int] = set()        # tolerate late task_end

    # ------------------------------------------------------------- lifecycle
    def task_begin(self, instance: int, key: TaskKey, priority: int,
                   arrival: Optional[float] = None) -> bool:
        """Elect a device for the task, then begin it there."""
        if arrival is None:
            arrival = self._clock()
        d = self._discipline(self, instance, key, priority, arrival)
        if not 0 <= d < self.devices:
            raise ValueError(f"discipline {self.discipline!r} placed task "
                             f"{instance} on device {d} of {self.devices}")
        self._device_of[instance] = d
        self._key_of[instance] = key
        self._instances[d].add(instance)
        self._inflight[instance] = 0
        return self.policies[d].task_begin(instance, key, priority,
                                           arrival=arrival)

    def task_end(self, instance: int) -> List[int]:
        if instance in self._cancelled:
            # the client's own retirement arriving after an ops-plane
            # cancel already retired the task — expected, not spurious
            self._cancelled.discard(instance)
            return []
        self._pause_pending.discard(instance)
        d = self._device_of.get(instance)
        if d is None:
            # duplicate/late retirement for a purged instance: tolerate
            # like kernel_end does (FikitPolicy.task_end pops tolerantly
            # too, so this was a no-op before the placement layer existed)
            self.spurious_task_ends += 1
            return []
        if self.online is not None:
            self.online.task_gone(instance)
        admitted = self.policies[d].task_end(instance)
        self._instances[d].discard(instance)
        self._retired.add(instance)
        self._stealable.discard(instance)
        self._maybe_purge(instance)
        self._maybe_steal()
        return admitted

    # --------------------------------------------------------------- routing
    def submit(self, req: KernelRequest) -> bool:
        paused = self._paused.get(req.task_instance)
        if paused is not None:
            # a paused task's client keeps issuing; buffer with the
            # detached backlog and replay in stream order on resume
            paused[1].append(req)
            return False
        d = self._device_of[req.task_instance]
        if self.devices > 1:
            # load/park bookkeeping feeds device election and steal
            # candidacy; at K=1 neither exists, so the pass-through skips
            # it and a single-device submit costs what a bare policy's does
            if self._needs_load:
                self._load[d] += self._predict(req)
            if self.steal_enabled:
                # record the park BEFORE forwarding: the policy may consume
                # the request synchronously (direct launch, or queued-then-
                # filled inside the same call) and the launch hook pops the
                # record again
                self._parked.setdefault(req.task_instance,
                                        OrderedDict())[req.uid] = req
        launched = self.policies[d].submit(req)
        if not launched and self.steal_enabled:
            self._update_stealable(req.task_instance)
            self._maybe_steal()
            # the steal may have migrated THIS task and launched the very
            # request that just parked; report what actually happened
            parked = self._parked.get(req.task_instance)
            launched = parked is None or req.uid not in parked
        return launched

    def fill_complete(self, device: int) -> None:
        self.policies[device].fill_complete()

    def kernel_end(self, instance: int, kernel_id, *, last: bool = False,
                   actual_gap: Optional[float] = None,
                   start: Optional[float] = None,
                   end: Optional[float] = None) -> None:
        """``start``/``end`` are the completed kernel's device-time
        brackets when the engine knows them — the online measurement
        loop's duration sample. Passed BEFORE the policy's ``kernel_end``
        so an epoch commit triggered by this very observation already
        serves refreshed predictions to the fill decision it runs."""
        d = self._device_of.get(instance)
        if d is None:
            # duplicate/late completion for an already-purged instance (an
            # engine bug, or a device thread racing a retry): tolerate and
            # count it, like FikitPolicy.fill_complete's clamp — a KeyError
            # here would kill a wall-clock device thread
            self.spurious_kernel_completions += 1
            return
        if self.online is not None and start is not None and end is not None:
            self.online.observe(d, instance, self._key_of[instance],
                                kernel_id, start, end, last=last)
        n = self._inflight.get(instance, 0)
        if n > 0:
            self._inflight[instance] = n - 1
        if self._needs_load:
            self._load[d] = max(
                0.0, self._load[d] - max(
                    0.0,
                    self.profiled.predict_duration(self._key_of[instance],
                                                   kernel_id)))
        self.policies[d].kernel_end(instance, kernel_id, last=last,
                                    actual_gap=actual_gap)
        self._maybe_purge(instance)
        if (instance in self._pause_pending
                and not self._inflight.get(instance, 0)):
            # a pause requested mid-kernel lands at THIS boundary: the
            # task's last in-flight kernel just finished
            self._do_pause(instance)
        if self.steal_enabled:
            # this completion may have made the task fully parked (zero in
            # flight, requests queued) — the moment it becomes stealable
            self._update_stealable(instance)
            self._maybe_steal()

    def _on_launch(self, device: int, req: KernelRequest,
                   filler: bool) -> None:
        """Per-device policy launch hook: track flight state, forward."""
        inst = req.task_instance
        self._inflight[inst] = self._inflight.get(inst, 0) + 1
        if self.steal_enabled:
            parked = self._parked.get(inst)
            if parked is not None:
                parked.pop(req.uid, None)
            self._stealable.discard(inst)       # a kernel is now in flight
        self._launch_hook(device, req, filler)

    # ------------------------------------------------------ lifecycle verbs
    def cancel(self, instance: int):
        """Cancel ``instance`` at a kernel boundary: purge its parked
        requests, retire it, but let in-flight kernels run to completion
        (kernels are non-preemptible — their completions are tolerated
        through the existing late-completion machinery). Returns
        ``(purged, admitted)``: the purged requests in stream order and
        any instances newly admitted by EXCLUSIVE serialization."""
        entry = self._paused.pop(instance, None)
        if entry is not None:
            # cancelling a paused task: its backlog is already detached
            self._cancelled.add(instance)
            return list(entry[1]), []
        self._pause_pending.discard(instance)
        d = self._device_of.get(instance)
        if d is None:
            if instance in self._retired or instance in self._cancelled:
                # cancel raced completion (or a second cancel): the task
                # already left the layer — terminal no-op, nothing purged
                return [], []
            raise ValueError(f"cannot cancel unknown instance {instance}")
        if self.online is not None:
            self.online.task_gone(instance)
        parked = (list(self._parked[instance].values())
                  if self.steal_enabled and instance in self._parked
                  else None)
        purged, admitted = self.policies[d].cancel_task(instance, parked)
        self._cancelled.add(instance)
        self._instances[d].discard(instance)
        self._retired.add(instance)
        self._stealable.discard(instance)
        if self.steal_enabled and instance in self._parked:
            self._parked[instance].clear()
        if self._needs_load:
            self._load[d] = max(0.0, self._load[d]
                                - sum(self._predict(r) for r in purged))
        self._maybe_purge(instance)
        self._maybe_steal()
        return purged, admitted

    def pause(self, instance: int) -> bool:
        """Pause ``instance``: detach it (and its parked backlog) from
        its device. With kernels in flight the pause DEFERS to the next
        kernel boundary of the task (returns False); otherwise it takes
        effect now (returns True). Idempotent. EXCLUSIVE mode has no
        pause — admission serialization would deadlock behind a paused
        admitted task."""
        if self.mode is Mode.EXCLUSIVE:
            raise ValueError("pause/resume are not supported in "
                             "EXCLUSIVE mode")
        if instance in self._paused:
            return True
        if self._device_of.get(instance) is None:
            raise ValueError(f"cannot pause unknown instance {instance}")
        if self._inflight.get(instance, 0) > 0:
            self._pause_pending.add(instance)
            return False
        self._do_pause(instance)
        return True

    def _do_pause(self, instance: int) -> None:
        """Take the pause at a kernel boundary: detach the task record
        and its parked requests out of the device's policy, park both in
        the layer (the engine checkpoints the store; the layer keeps the
        live objects), free the device."""
        d = self._device_of.pop(instance)
        self._pause_pending.discard(instance)
        if self.online is not None:
            # a resumed task may land on a different device/timeline: its
            # launch-to-launch gap anchor would be meaningless
            self.online.task_gone(instance)
        parked = (list(self._parked[instance].values())
                  if self.steal_enabled and instance in self._parked
                  else None)
        at, reqs = self.policies[d].pause_task(instance, parked)
        self._instances[d].discard(instance)
        self._stealable.discard(instance)
        self._inflight.pop(instance, None)
        self._parked.pop(instance, None)
        self._key_of.pop(instance, None)
        if self._needs_load:
            self._load[d] = max(0.0, self._load[d]
                                - sum(self._predict(r) for r in reqs))
        self._paused[instance] = (at, list(reqs))
        self._maybe_steal()                     # the device may be idle now

    def resume(self, instance: int, device: Optional[int] = None) -> int:
        """Re-admit a paused task, on ``device`` or (by default) wherever
        the placement discipline elects NOW — a resumed task is a fresh
        placement decision, which is how a pause/resume pair migrates a
        task off a hot device. Replays the detached backlog in stream
        order. Returns the hosting device."""
        entry = self._paused.pop(instance, None)
        if entry is None:
            if instance in self._pause_pending:
                # resume raced a deferred pause: the pause never took
                # effect, the task never left its device
                self._pause_pending.discard(instance)
                return self._device_of[instance]
            raise ValueError(f"instance {instance} is not paused")
        at, reqs = entry
        if device is None:
            device = self._discipline(self, at.instance, at.key,
                                      at.priority, at.arrival)
        if not 0 <= device < self.devices:
            raise ValueError(f"resume of {instance} onto device {device} "
                             f"of {self.devices}")
        self._device_of[instance] = device
        self._key_of[instance] = at.key
        self._instances[device].add(instance)
        self._inflight[instance] = 0
        self.policies[device].attach_task(at)
        for r in reqs:                 # full submit(): load/park/steal
            self.submit(r)             # bookkeeping comes back with it
        return device

    @property
    def paused(self) -> Set[int]:
        return set(self._paused)

    # -------------------------------------------------------------- stealing
    def _update_stealable(self, instance: int) -> None:
        """Recompute one instance's steal candidacy: fully parked (zero in
        flight, >= 1 queued request) and not retired."""
        if (instance not in self._retired
                and not self._inflight.get(instance, 0)
                and self._parked.get(instance)):
            self._stealable.add(instance)
        else:
            self._stealable.discard(instance)

    def _maybe_steal(self) -> None:
        """Give every idle device a chance to steal a parked task."""
        if not self.steal_enabled or not self._stealable:
            return
        for s in range(self.devices):
            if not self._instances[s]:
                self._steal_to(s)
                if not self._stealable:
                    return

    def _steal_to(self, s: int) -> bool:
        """Steal the best fully-parked task onto idle device ``s``. Best =
        highest priority (ties: earliest arrival, lowest instance) — the
        task most hurt by waiting out a foreign holder. O(candidates), not
        O(resident tasks): the candidate set is maintained incrementally.
        Returns True iff a task moved."""
        best = None
        for i in self._stealable:
            b = self._device_of[i]
            if b == s:
                continue                        # already here (defensive)
            at = self.policies[b].active[i]
            cand = (at.priority, at.arrival, at.instance, b)
            if best is None or cand < best:
                best = cand
        if best is None:
            return False
        _, _, inst, b = best
        if self.online is not None:
            # the task changes devices: its launch-to-launch gap anchor is
            # meaningless across timelines, drop it
            self.online.task_gone(inst)
        at, reqs = self.policies[b].detach_task(
            inst, list(self._parked[inst].values()))
        self._instances[b].discard(inst)
        self._instances[s].add(inst)
        self._device_of[inst] = s
        if self._needs_load:
            moved = sum(self._predict(r) for r in reqs)
            self._load[b] = max(0.0, self._load[b] - moved)
            self._load[s] += moved
        self.steal_count += 1
        dst = self.policies[s]
        dst.attach_task(at)
        for r in reqs:                 # device s is idle: these launch now
            dst.submit(r)
        self._update_stealable(inst)
        return True

    # -------------------------------------------------------------- plumbing
    def _predict(self, req: KernelRequest) -> float:
        return max(0.0, self.profiled.predict_duration(req.task_key,
                                                       req.kernel_id))

    def _maybe_purge(self, instance: int) -> None:
        """Drop a retired instance's bookkeeping once its last completion
        has been observed (task_end and final kernel_end arrive in either
        order in the wall-clock engine)."""
        if instance in self._retired and not self._inflight.get(instance, 0):
            self._retired.discard(instance)
            self._inflight.pop(instance, None)
            self._parked.pop(instance, None)
            self._stealable.discard(instance)
            self._device_of.pop(instance, None)
            self._key_of.pop(instance, None)

    # ----------------------------------------------------------- inspection
    def device_of(self, instance: int) -> Optional[int]:
        """Device currently hosting ``instance`` (None once purged)."""
        return self._device_of.get(instance)

    def queued_of(self, instance: int) -> int:
        if self.steal_enabled:                 # _parked mirrors the queues
            parked = self._parked.get(instance)
            return len(parked) if parked else 0
        d = self._device_of.get(instance)      # inspection-only: scan
        if d is None:
            return 0
        return sum(1 for r in self.policies[d].queues
                   if r.task_instance == instance)

    def inflight_of(self, instance: int) -> int:
        return self._inflight.get(instance, 0)

    def predicted_load(self, device: int) -> float:
        return self._load[device]

    @property
    def traces(self) -> List:
        return [p.trace for p in self.policies]

    @property
    def fill_count(self) -> int:
        return sum(p.fill_count for p in self.policies)

    @property
    def overshoot_time(self) -> float:
        return sum(p.overshoot_time for p in self.policies)

    @property
    def queued(self) -> int:
        return sum(p.queued for p in self.policies)

    @property
    def spurious_fill_completions(self) -> int:
        return sum(p.spurious_fill_completions for p in self.policies)
