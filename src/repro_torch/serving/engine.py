"""Priority serving engine: hosts model services on a node of ``devices=K``
serial device executors (default one) under the FIKIT scheduler — the
port of ``repro.serving.engine`` (the paper's cloud-serving deployment).

Lifecycle per the paper (Fig 3):
1. A new service is profiled: T exclusive measured runs -> SK/SG stats
   loaded into the scheduler (measurement phase).
2. All later invocations run in the sharing phase: kernel-ID identification
   only, priority queues + gap filling decide placement.

Any scheduling ``Mode`` can host the system: FIKIT (the paper), SHARING
(default GPU), EXCLUSIVE (serialized), or PREEMPT. All modes share one
decision core, ``repro_torch.core.policy.FikitPolicy``; ``devices=K``
spreads invocations over K executors through
``repro_torch.core.placement.PlacementLayer``. The K executors are
scheduling lanes; every service's tensors live on its own ``device``.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from repro_torch.config import ModelConfig
from repro_torch.core import jobstore as _js
from repro_torch.core.client import HookClient, new_instance
from repro_torch.core.executor import JobCancelled, WallClockEngine
from repro_torch.core.jobstore import coerce_store
from repro_torch.core.profiler import ProfiledData, Profiler
from repro_torch.core.scheduler import Mode
from repro_torch.core.task import TaskKey
from repro_torch.models import api
from repro_torch.models.segmentation import SegmentedService
from repro_torch.serving.admission import AdmissionPlane, coerce_admission

logger = logging.getLogger(__name__)


class InferenceService:
    """One hosted model (a dense decoder, the mamba2 SSM or the
    recurrentgemma hybrid) + its priority + its profile state. The weights are random, drawn on
    ``device`` from ``seed``."""

    def __init__(self, cfg: ModelConfig, priority: int, batch: int = 1,
                 seq: int = 32, host_gap: float = 0.0, tail_gap: float = 0.0,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.priority = priority
        self.key = TaskKey(cfg.name, (batch, seq))
        model = api.build_params(cfg, seed, device)
        self.svc = SegmentedService(cfg, model, batch, seq,
                                    host_gap=host_gap, tail_gap=tail_gap)
        self.profiled = False

    def client(self, engine: WallClockEngine, identify: bool = True):
        return HookClient(engine, self.key, self.priority,
                          self.svc.segments, identify=identify)


class ServingSystem:
    """Owns the engine + profile store; runs measurement then sharing.

    ``discipline`` elects the device per invocation (placement);
    ``queue_discipline`` orders parked requests within each device's
    priority levels ("fifo" default / "sjf" / "edf"). Invocations may
    carry a relative ``deadline`` budget (seconds): it is tagged onto
    every kernel request (consulted by edf levels) and drives the
    ``deadline_misses``/``deadlines_tagged`` serving stats."""

    def __init__(self, mode: Mode = Mode.FIKIT, measure_runs: int = 5,
                 devices: int = 1, discipline: str = "least_loaded",
                 queue_discipline: str = "fifo", online_measure=False,
                 interference=None, jobstore=None, admission=None):
        """``online_measure`` (False / True / ``repro_torch.core.online.
        OnlineConfig``) enables live SK/SG refinement during the sharing
        phase: every dispatched segment's device-time bracket feeds
        EMA-smoothed profile updates (committed in epochs), never-profiled
        services get cold-start provisional durations instead of being
        invisible to gap filling, and ``online_stats`` reports
        observation/commit/drift counters. Off (default) is the paper's
        strictly-offline two-phase behavior.

        ``interference`` (None / True / mapping /
        ``repro_torch.core.interference.InterferenceModel``) enables
        interference-aware gap filling in the hosted engine; off (None,
        default) keeps scheduling bit-identical to interference-off.

        ``jobstore`` (None / path / ``repro_torch.core.jobstore.JobStore``)
        attaches the durable ops plane: every invocation gets a job row,
        every finished kernel a write-ahead completion record (committed
        by the device thread BEFORE the boundary's scheduling
        side-effects), terminal states and profile snapshots persist,
        and a poller thread consumes operator control verbs written into
        the store by the ``repro_torch.launch.serve`` CLI. The store only
        observes — scheduling decisions are identical with or without
        one. Wall-clock recovery is invocation-level: ``recover()``
        re-runs each incomplete invocation from its service definition
        (payloads are live callables, not replayable records), unlike
        the simulator's kernel-exact ``SimScheduler.recover``.

        ``admission`` (None / True / ``QoSClass`` sequence / dict of
        ``repro_torch.serving.admission.AdmissionPlane`` kwargs) attaches the
        async admission plane: per-tenant QoS classes mapped onto FIKIT
        priorities, bounded queues with backpressure, SLO-aware
        shedding, and continuous batching, served by one dispatcher
        thread over the non-blocking submit path (``submit_async``).
        None (default) leaves the direct ``invoke`` path — and the
        engine's decision traces — exactly as before."""
        self.profiles = ProfiledData()
        self.mode = mode
        self.measure_runs = measure_runs
        self.devices = devices
        self.discipline = discipline
        self.queue_discipline = queue_discipline
        self.online_measure = online_measure
        self.interference = interference
        self.engine: Optional[WallClockEngine] = None
        self.deadline_misses = 0
        self.deadlines_tagged = 0
        self.cancelled_invocations = 0
        self._stats_lock = threading.Lock()
        self._final_online_stats: Optional[dict] = None
        self._stopped = False
        # ops plane: durable store + instance<->job maps + control poller
        self.jobstore = coerce_store(jobstore)
        self._job_of_inst: Dict[int, int] = {}
        self._inst_of_job: Dict[int, int] = {}
        self._snap_commits = 0
        self._poll_stop: Optional[threading.Event] = None
        self._poller: Optional[threading.Thread] = None
        self._poll_join_timeout = 5.0
        self.rejected_controls = 0     # unapplicable operator verbs consumed
        self.poller_deaths = 0         # unexpected poller-killing errors
        # admission plane (built per start(); None = direct-invoke only)
        self._admission_spec = coerce_admission(admission)
        self.admission: Optional[AdmissionPlane] = None

    def start(self) -> "ServingSystem":
        """Build + start a fresh engine. Clears any final-stats snapshot a
        previous start/stop cycle cached, so ``online_stats`` reflects THIS
        engine, not a stale restart leftover. With a jobstore attached,
        also reloads the latest profile snapshot (online-learned SK/SG
        survive a restart) and starts the control poller."""
        self._final_online_stats = None
        self._stopped = False
        if self.jobstore is not None:
            snap = self.jobstore.load_profiles()
            if snap is not None:
                # merge the checkpointed (possibly online-refined) SK/SG
                # into the live profile store the engine will serve from
                for prof in snap._by_key.values():
                    self.profiles.load(prof)
        self.engine = WallClockEngine(
            self.mode, self.profiles, devices=self.devices,
            discipline=self.discipline,
            queue_discipline=self.queue_discipline,
            online=self.online_measure or None,
            interference=self.interference,
            on_kernel_complete=(self._on_kernel_complete
                                if self.jobstore is not None
                                else None)).start()
        if self.jobstore is not None:
            self._poll_stop = threading.Event()
            self._poller = threading.Thread(target=self._poll_controls,
                                            args=(self._poll_stop,),
                                            daemon=True,
                                            name="fikit-ops-poller")
            self._poller.start()
        if self._admission_spec is not None:
            self.admission = AdmissionPlane(self,
                                            **self._admission_spec).start()
        return self

    def stop(self) -> None:
        """Stop the engine (idempotent; a no-op before ``start()``). With
        a jobstore attached, also stops the control poller and writes a
        final profile snapshot + WAL checkpoint — UNLESS the poller
        failed to join in time: a wedged verb handler could still be
        writing ``snapshot_profiles`` against the store mid-checkpoint,
        so the final snapshot is skipped with a warning instead of
        racing it."""
        if self._stopped or self.engine is None:
            self._stopped = True
            return
        self._stopped = True
        if self.admission is not None:
            # drain the plane first: queued work resolves (REQUEUED) and
            # in-flight groups finish while the device threads still run
            self.admission.drain(timeout=5)
            self.admission.stop()
        poller_wedged = False
        if self._poll_stop is not None:
            self._poll_stop.set()
            self._poller.join(timeout=self._poll_join_timeout)
            poller_wedged = self._poller.is_alive()
            self._poll_stop = None
            self._poller = None
        self.engine.stop()
        if self.engine.online is not None and self.engine.online.config.enabled:
            self._final_online_stats = self.engine.online.stats()  # post-flush
        if self.jobstore is not None:
            if poller_wedged:
                logger.warning(
                    "ops poller did not exit within %.1fs — skipping the "
                    "final profile snapshot/checkpoint so a wedged verb "
                    "handler cannot race the store shutdown",
                    self._poll_join_timeout)
            else:
                self.jobstore.snapshot_profiles(self.profiles)
                self.jobstore.checkpoint()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def online_stats(self) -> Optional[dict]:
        """Online measurement counters: live while serving, the final
        (post-flush) snapshot after the context manager exits, None when
        ``online_measure`` is off."""
        if self._final_online_stats is not None:
            return self._final_online_stats
        if self.engine is not None:
            return self.engine.online_stats()
        return None

    # ------------------------------------------------------------ lifecycle
    def onboard(self, service: InferenceService) -> List[float]:
        """Measurement phase: T exclusive measured runs (paper: T in
        [10, 1000]); returns the measured-phase JCTs."""
        service.svc.warmup()
        prof = Profiler(service.key)
        jcts = []
        meas_engine = WallClockEngine(Mode.EXCLUSIVE).start()
        try:
            cl = HookClient(meas_engine, service.key, service.priority,
                            service.svc.segments)
            for _ in range(self.measure_runs):
                state = service.svc.make_input()
                _, jct = cl.measure_run(state, prof)
                jcts.append(jct)
        finally:
            meas_engine.stop()
        self.profiles.load(prof.statistics())
        service.profiled = True
        return jcts

    def invoke(self, service: InferenceService, n: int = 1,
               interval: float = 0.0,
               deadline: Optional[float] = None) -> List[float]:
        """n sharing-phase invocations; returns JCTs of the invocations
        that COMPLETED (one cancelled mid-flight by an ops-plane verb is
        counted in ``self.cancelled_invocations`` instead of hanging or
        raising out of the batch). ``deadline`` is a per-invocation
        completion budget in seconds; when given, every kernel request
        is deadline-tagged (edf levels order by it) and invocations
        finishing past the budget count into ``self.deadline_misses``."""
        if self.engine is None:
            raise RuntimeError(
                "ServingSystem.invoke() before start() — the engine does "
                "not exist yet; use the context manager or call start()")
        if self._stopped:
            raise RuntimeError(
                "ServingSystem.invoke() after stop() — the engine's "
                "device threads have exited; call start() again first")
        cl = service.client(self.engine)
        jcts = []
        for _ in range(n):
            jct = self._invoke_one(cl, service, deadline=deadline)
            if jct is not None:
                jcts.append(jct)
            if interval > 0:
                time.sleep(interval)
        return jcts

    def _invoke_one(self, cl: HookClient, service: InferenceService,
                    deadline: Optional[float] = None,
                    job_id: Optional[int] = None) -> Optional[float]:
        """One sharing-phase invocation under an (optional) durable job
        record. Returns the JCT, or None when the invocation was
        cancelled by an ops-plane verb."""
        inst = new_instance()
        if self.jobstore is not None:
            job_id = self.jobstore.record_submit(
                job_id, service.key, service.priority,
                n_kernels=len(service.svc.segments),
                deadline=deadline, state=_js.RUNNING)
            with self._stats_lock:
                self._job_of_inst[inst] = job_id
                self._inst_of_job[job_id] = inst
        state = service.svc.make_input()
        try:
            _, jct = cl.run(state, deadline=deadline, instance=inst)
        except JobCancelled:
            with self._stats_lock:
                self.cancelled_invocations += 1
            return None
        finally:
            if self.jobstore is not None:
                with self._stats_lock:
                    self._job_of_inst.pop(inst, None)
                    self._inst_of_job.pop(job_id, None)
        if self.jobstore is not None:
            self.jobstore.record_state(job_id, _js.DONE)
        if deadline is not None:
            with self._stats_lock:
                self.deadlines_tagged += 1
                if jct > deadline:
                    self.deadline_misses += 1
        return jct

    # ------------------------------------------------------ async admission
    def _invoke_async(self, service: InferenceService, on_done,
                      deadline: Optional[float] = None,
                      job_id: Optional[int] = None) -> int:
        """Non-blocking ``_invoke_one``: submits through
        ``HookClient.run_async`` and returns the instance id at once.
        ``on_done(jct, error)`` fires from a device thread when the
        invocation retires — ``(jct, None)`` on success, ``(None, None)``
        when an ops-plane cancel hit it (counted like the sync path),
        ``(None, error)`` when a payload failed. Shares the jobstore and
        deadline-stat bookkeeping with the blocking path."""
        if self.engine is None:
            raise RuntimeError("ServingSystem._invoke_async() before "
                               "start() — the engine does not exist yet")
        if self._stopped:
            raise RuntimeError("ServingSystem._invoke_async() after stop()")
        inst = new_instance()
        if self.jobstore is not None:
            job_id = self.jobstore.record_submit(
                job_id, service.key, service.priority,
                n_kernels=len(service.svc.segments),
                deadline=deadline, state=_js.RUNNING)
            with self._stats_lock:
                self._job_of_inst[inst] = job_id
                self._inst_of_job[job_id] = inst
        cl = service.client(self.engine)
        state = service.svc.make_input()

        def done(result, jct, error) -> None:
            if self.jobstore is not None:
                with self._stats_lock:
                    self._job_of_inst.pop(inst, None)
                    self._inst_of_job.pop(job_id, None)
            if isinstance(error, JobCancelled):
                with self._stats_lock:
                    self.cancelled_invocations += 1
                on_done(None, None)
                return
            if error is not None:
                on_done(None, error)
                return
            if self.jobstore is not None:
                self.jobstore.record_state(job_id, _js.DONE)
            if deadline is not None:
                with self._stats_lock:
                    self.deadlines_tagged += 1
                    if jct > deadline:
                        self.deadline_misses += 1
            on_done(jct, None)

        cl.run_async(state, done, deadline=deadline, instance=inst)
        return inst

    def submit_async(self, service: InferenceService, qos: str,
                     deadline=...):
        """Offer one invocation to the admission plane (see
        ``repro_torch.serving.admission``); returns its ``AdmissionTicket``
        immediately. Requires ``admission=`` at construction."""
        if self.admission is None:
            raise RuntimeError(
                "ServingSystem.submit_async() needs the admission plane — "
                "construct with admission=True (or QoS classes)")
        if deadline is ...:
            return self.admission.submit(service, qos)
        return self.admission.submit(service, qos, deadline=deadline)

    def invoke_concurrent(self, plans) -> Dict[str, List[float]]:
        """plans: list of (name, service, n, interval, start_delay) tuples,
        optionally extended with a 6th ``deadline`` element (relative
        seconds per invocation). Runs each plan in its own client thread;
        returns JCTs per name.

        A runner thread that raises (a failing payload propagates out of
        ``invoke``) no longer dies silently leaving its name missing
        from the result — every plan's exception is captured and the
        first one (in plan order) re-raised after all threads joined."""
        if self.engine is None or self._stopped:
            raise RuntimeError("ServingSystem.invoke_concurrent() outside "
                               "a start()/stop() window")
        out: Dict[str, List[float]] = {}
        errors: Dict[str, BaseException] = {}
        threads = []

        def runner(name, service, n, interval, delay, deadline=None):
            if delay > 0:
                time.sleep(delay)
            try:
                out[name] = self.invoke(service, n=n, interval=interval,
                                        deadline=deadline)
            except BaseException as e:
                errors[name] = e

        for plan in plans:
            threads.append(threading.Thread(target=runner, args=plan))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            for plan in plans:           # re-raise the FIRST, plan order
                if plan[0] in errors:
                    raise errors[plan[0]]
        return out

    # ------------------------------------------------------------ ops plane
    def _on_kernel_complete(self, req, start: float, end: float) -> None:
        """Engine hook (device thread, engine lock held): write-ahead
        record of a finished kernel, before the boundary's scheduling
        side-effects."""
        with self._stats_lock:
            job = self._job_of_inst.get(req.task_instance)
        if job is not None:
            self.jobstore.record_completion(job, req.seq_index)

    def _poll_controls(self, stop_ev: threading.Event) -> None:
        """Poller thread: consume operator verbs from the store's control
        queue (written by the serve CLI against the same store file) and
        checkpoint profiles whenever an online epoch committed.

        Only the EXPECTED unapplicable-verb errors (``ValueError`` for an
        unknown/finished job, ``KeyError`` for a vanished instance) are
        absorbed — counted in ``rejected_controls`` and surfaced via
        ``status()``. Anything else is a real bug (e.g. a store error
        mid-``cancel``): it is logged with traceback, counted in
        ``poller_deaths``, and kills the poller rather than vanishing."""
        try:
            while not stop_ev.wait(0.05):
                for verb, job_id, arg in self.jobstore.pop_controls():
                    try:
                        if verb == "cancel":
                            self.cancel(job_id)
                        elif verb == "pause":
                            self.pause(job_id)
                        elif verb == "resume":
                            self.resume(job_id,
                                        int(arg) if arg is not None else None)
                        elif verb == "drain":
                            self.drain()
                        else:
                            raise ValueError(f"unknown control verb {verb!r}")
                    except (ValueError, KeyError):
                        # unapplicable operator verb (unknown/finished
                        # job): the row stays consumed, status() shows
                        # the rejection count + the job's actual state
                        with self._stats_lock:
                            self.rejected_controls += 1
                eng = self.engine
                if (eng is not None and eng.online is not None
                        and eng.online.commits != self._snap_commits):
                    self._snap_commits = eng.online.commits
                    self.jobstore.snapshot_profiles(self.profiles)
        except Exception:
            with self._stats_lock:
                self.poller_deaths += 1
            logger.exception("ops-control poller died on an unexpected "
                             "error; operator verbs will no longer apply "
                             "to this serving process")

    def _live_instance(self, job_id: int) -> int:
        with self._stats_lock:
            inst = self._inst_of_job.get(job_id)
        if inst is None:
            raise ValueError(f"job {job_id} has no live invocation")
        return inst

    def cancel(self, job_id: int) -> int:
        """Cancel a live invocation by job id: purge its queued kernels
        (its client unblocks with ``JobCancelled``), let in-flight
        kernels finish, record the terminal state. Returns the number of
        purged requests."""
        inst = self._live_instance(job_id)
        purged = self.engine.cancel(inst)
        if self.jobstore is not None:
            self.jobstore.record_state(job_id, _js.CANCELLED)
        return purged

    def pause(self, job_id: int) -> bool:
        """Pause a live invocation at its next kernel boundary; its
        client blocks on the paused kernel's Future until ``resume``."""
        inst = self._live_instance(job_id)
        landed = self.engine.pause(inst)
        if self.jobstore is not None:
            self.jobstore.record_state(job_id, _js.PAUSED)
        return landed

    def resume(self, job_id: int, device: Optional[int] = None) -> int:
        """Resume a paused invocation — on ``device``, or wherever the
        placement discipline elects now (cross-device migration)."""
        inst = self._live_instance(job_id)
        d = self.engine.resume(inst, device)
        if self.jobstore is not None:
            self.jobstore.record_state(job_id, _js.RUNNING)
        return d

    def drain(self, timeout: float = 10.0) -> bool:
        """Stop admitting, finish in-flight work, flush online epochs,
        checkpoint the store. Returns True when fully drained in time."""
        if self.engine is None:
            return True
        drained = self.engine.drain(timeout=timeout)
        if self.jobstore is not None:
            self.jobstore.snapshot_profiles(self.profiles)
            self.jobstore.checkpoint()
        return drained

    def status(self) -> dict:
        """Operator summary: job rows by state + engine counters +
        control-poller health + per-QoS-class admission stats. When a
        worker fleet has registered against the attached store, its
        rows (per-worker counters + states) ride along under
        ``workers`` — the aggregated view lives in
        ``repro_torch.serving.workers.fleet_status``."""
        out = {"mode": self.mode.value,
               "devices": self.devices,
               "cancelled_invocations": self.cancelled_invocations,
               "rejected_controls": self.rejected_controls,
               "poller_deaths": self.poller_deaths,
               "poller_alive": (self._poller is not None
                                and self._poller.is_alive())}
        if self.admission is not None:
            out["admission"] = self.admission.stats()
        if self.jobstore is not None:
            jobs = self.jobstore.jobs()
            out["jobs"] = [{"job_id": j.job_id, "process": j.key.process,
                            "priority": j.priority, "state": j.state,
                            "completed": j.completed,
                            "n_kernels": j.n_kernels} for j in jobs]
            by_state: Dict[str, int] = {}
            for j in jobs:
                by_state[j.state] = by_state.get(j.state, 0) + 1
            out["by_state"] = by_state
            workers = self.jobstore.workers()
            if workers:
                out["workers"] = workers
        if self.engine is not None:
            out["fills"] = self.engine.fill_count
            out["steals"] = self.engine.steal_count
        return out

    def recover(self, services: List[InferenceService]) -> List[int]:
        """Re-run every incomplete invocation recorded in the store.

        Wall-clock payloads are live callables, so recovery here is
        INVOCATION-level at-least-once: each incomplete job's completion
        watermark resets and the invocation re-runs in full from its
        service definition (matched by ``TaskKey``) under its original
        job id. Invocations recorded ``done`` are never re-run — the
        exactly-once side of the contract. The simulator's
        ``SimScheduler.recover`` is the kernel-exact counterpart.
        Returns the recovered job ids (unknown keys are skipped)."""
        if self.jobstore is None:
            raise RuntimeError("recover() needs a jobstore attached")
        if self.engine is None or self._stopped:
            raise RuntimeError("recover() inside a start()/stop() window "
                               "only — the engine must be serving")
        by_key = {s.key: s for s in services}
        redone: List[int] = []
        for rec in self.jobstore.incomplete_jobs(include_paused=True):
            svc = by_key.get(rec.key)
            if svc is None:
                continue
            self.jobstore.reset_completions(rec.job_id)
            cl = svc.client(self.engine)
            self._invoke_one(cl, svc, deadline=rec.deadline,
                             job_id=rec.job_id)
            redone.append(rec.job_id)
        return redone
