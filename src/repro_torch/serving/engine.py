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

import threading
import time
from typing import Dict, List, Optional

from repro_torch.config import ModelConfig
from repro_torch.core.client import HookClient
from repro_torch.core.executor import WallClockEngine
from repro_torch.core.policy import Mode
from repro_torch.core.profiler import ProfiledData, Profiler
from repro_torch.core.task import TaskKey
from repro_torch.models import api
from repro_torch.models.segmentation import SegmentedService


class InferenceService:
    """One hosted model + its priority + its profile state. The weights
    are random, drawn on ``device`` from ``seed``."""

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
    ``deadline_misses``/``deadlines_tagged`` serving stats.

    ``online_measure`` (False / True / ``OnlineConfig``) refines SK/SG
    live during the sharing phase; ``interference`` enables
    interference-aware gap filling — both as in the JAX package.

    Not ported yet (a later slice): the durable ops plane (``jobstore=``,
    with cancel/pause/resume/drain/recover) and the async admission plane
    (``admission=``, ``submit_async``).
    """

    def __init__(self, mode: Mode = Mode.FIKIT, measure_runs: int = 5,
                 devices: int = 1, discipline: str = "least_loaded",
                 queue_discipline: str = "fifo", online_measure=False,
                 interference=None):
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
        self._stats_lock = threading.Lock()
        self._final_online_stats: Optional[dict] = None
        self._stopped = False

    def start(self) -> "ServingSystem":
        """Build + start a fresh engine. Clears any final-stats snapshot a
        previous start/stop cycle cached, so ``online_stats`` reflects THIS
        engine."""
        self._final_online_stats = None
        self._stopped = False
        self.engine = WallClockEngine(
            self.mode, self.profiles, devices=self.devices,
            discipline=self.discipline,
            queue_discipline=self.queue_discipline,
            online=self.online_measure or None,
            interference=self.interference).start()
        return self

    def stop(self) -> None:
        """Stop the engine (idempotent; a no-op before ``start()``)."""
        if self._stopped or self.engine is None:
            self._stopped = True
            return
        self._stopped = True
        self.engine.stop()
        if self.engine.online is not None and self.engine.online.config.enabled:
            self._final_online_stats = self.engine.online.stats()  # post-flush

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
        """n sharing-phase invocations; returns their JCTs. ``deadline``
        is a per-invocation completion budget in seconds; when given,
        every kernel request is deadline-tagged (edf levels order by it)
        and invocations finishing past the budget count into
        ``self.deadline_misses``."""
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
            state = service.svc.make_input()
            _, jct = cl.run(state, deadline=deadline)
            jcts.append(jct)
            if deadline is not None:
                with self._stats_lock:
                    self.deadlines_tagged += 1
                    if jct > deadline:
                        self.deadline_misses += 1
            if interval > 0:
                time.sleep(interval)
        return jcts

    def invoke_concurrent(self, plans) -> Dict[str, List[float]]:
        """plans: list of (name, service, n, interval, start_delay) tuples,
        optionally extended with a 6th ``deadline`` element (relative
        seconds per invocation). Runs each plan in its own client thread;
        returns JCTs per name. Every plan's exception is captured and the
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

    def status(self) -> dict:
        """Operator summary: mode, executors and engine counters."""
        out = {"mode": self.mode.value, "devices": self.devices}
        if self.engine is not None:
            out["fills"] = self.engine.fill_count
            out["steals"] = self.engine.steal_count
        return out
