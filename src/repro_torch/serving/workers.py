"""N engine workers draining ONE durable job store.

FIKIT's cloud framing assumes "always more task requests than the
number of GPU available": a single engine process is the bottleneck
long before the devices are. This module fans the serving path out to
N worker processes that share one ``JobStore`` file — the store is the
only coordination surface, exactly as the PR-7 ops plane intended.

The protocol, layer by layer:

- **Claiming** — ``JobStore.claim_jobs`` hands a worker a strict-
  priority batch of ``submitted`` jobs inside one ``BEGIN IMMEDIATE``
  transaction; two workers can never claim the same row.
- **Leases** — every claimed row carries ``owner`` + ``lease_expires``.
  A heartbeat thread renews them while the batch runs; if the worker
  dies, survivors ``reap_expired`` the rows back to ``submitted`` and
  the next claim re-runs exactly the remaining kernel suffix (the
  completion watermark survives — this IS the PR-7 recovery path, just
  triggered by a peer instead of a restart).
- **Sharding** — jobs are stamped with a ``qos`` shard key at submit
  time; a worker claims its own shards first and (optionally) STEALS
  from any shard when its own are empty, mirroring the placement
  layer's idle-device work stealing.
- **Equivalence pin** — a single worker claiming everything in one
  batch sorts the batch by job id, which is precisely
  ``JobStore.recovery_plan`` order: its decision trace is identical to
  ``SimScheduler.recover(store, mode).run()``. The differential suite
  holds this contract.

Workers run the pure-python scheduler core only (no JAX import — see
the lazy ``repro_torch.serving.__init__``), so ``python -m
repro_torch.serving.workers`` starts in milliseconds.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import jobstore as _js
from repro_torch.core.faults import FaultPlan
from repro_torch.core.jobstore import (JobRecord, coerce_store, spec_from_record,
                                 spec_to_obj)
from repro_torch.core.policy import Mode
from repro_torch.core.scheduler import SimScheduler, profile_tasks
from repro_torch.core.task import TaskSpec

#: Coordination flags (``JobStore.set_flag`` namespace) the fleet obeys.
GO_FLAG = "workers_go"          # supervisor start gate (timing fairness)
STOP_FLAG = "workers_stop"      # graceful drain: finish batch, then exit


# --------------------------------------------------------------- wall sink
class _PacedStore:
    """Store proxy a worker's simulator writes through.

    Two jobs: (1) force every write's timestamp to WALL time (the
    virtual-time sim passes ``at=self.now``, which is meaningless across
    processes — fleet JCT stats subtract ``submitted_at`` stamped by a
    different clock); (2) optionally SLEEP ``pace_s`` per kernel
    completion, converting the virtual-time replay into wall-bounded
    work so multi-process goodput scaling is measurable. Everything
    else delegates to the wrapped store."""

    def __init__(self, store, pace_s: float = 0.0):
        self._store = store
        self._pace_s = pace_s

    def record_submit(self, job_id, key, priority, **kw):
        kw.pop("at", None)
        return self._store.record_submit(job_id, key, priority, **kw)

    def record_state(self, job_id, state, at=None):
        return self._store.record_state(job_id, state)

    def record_completion(self, job_id, seq, at=None):
        if self._pace_s > 0.0:
            time.sleep(self._pace_s)    # no store lock held while pacing
        return self._store.record_completion(job_id, seq)

    def snapshot_profiles(self, data, at=None):
        return self._store.snapshot_profiles(data)

    def __getattr__(self, name):
        return getattr(self._store, name)


# ------------------------------------------------------------------ worker
@dataclass
class WorkerConfig:
    """One engine worker's knobs.

    ``shards`` restricts claims to those qos shard keys (None = claim
    any); ``steal=True`` lets a sharded worker fall back to any-shard
    claims when its own shards are empty. ``pace_s`` is the per-kernel
    wall pacing the batch simulator runs under (0 = as fast as the
    store can write). ``drain_on_empty`` exits the claim loop once the
    store has nothing pending AND nothing leased; ``wait_go`` parks the
    worker on the supervisor's ``workers_go`` flag before the first
    claim so a fleet starts its clock together. ``fault_plan`` wires a
    scripted crash into the FIRST batch (test hook)."""
    worker_id: str = "w0"
    mode: Mode = Mode.FIKIT
    lease_s: float = 5.0
    heartbeat_s: float = 1.0
    poll_s: float = 0.05
    batch: int = 16
    shards: Optional[Tuple[str, ...]] = None
    steal: bool = True
    pace_s: float = 0.0
    drain_on_empty: bool = True
    wait_go: bool = False
    fault_plan: Optional[FaultPlan] = None


class EngineWorker:
    """One claim-run-repeat loop over a shared ``JobStore``.

    Each batch is executed by a real ``SimScheduler`` with the store
    attached, so the PR-7 write-order contract (write-ahead
    completions, terminal state last) holds per worker; the lease
    protocol extends it across workers."""

    def __init__(self, store, config: Optional[WorkerConfig] = None):
        self.store = coerce_store(store)
        self.cfg = config or WorkerConfig()
        self.last_sim: Optional[SimScheduler] = None
        self.jobs_done = 0
        self.kernels_done = 0
        self.steals = 0
        self.batches = 0
        self.lost_lease = False

    # ------------------------------------------------------------- loop
    def run(self) -> dict:
        """Drain the store; returns this worker's summary counters."""
        cfg, store = self.cfg, self.store
        store.register_worker(cfg.worker_id)
        if cfg.wait_go:
            while store.flag(GO_FLAG) is None:
                if store.flag(STOP_FLAG) is not None:
                    store.worker_update(cfg.worker_id, state="stopped")
                    return self.summary()
                time.sleep(0.005)
        try:
            while store.flag(STOP_FLAG) is None:
                store.reap_expired(by=cfg.worker_id)
                recs = store.claim_jobs(cfg.worker_id, limit=cfg.batch,
                                        lease_s=cfg.lease_s,
                                        shards=cfg.shards)
                stolen = 0
                if not recs and cfg.steal and cfg.shards is not None:
                    recs = store.claim_jobs(cfg.worker_id,
                                            limit=cfg.batch,
                                            lease_s=cfg.lease_s)
                    stolen = sum(1 for r in recs
                                 if r.qos not in cfg.shards)
                if not recs:
                    if (cfg.drain_on_empty and store.pending_jobs() == 0
                            and store.leased_jobs() == 0):
                        break
                    time.sleep(cfg.poll_s)
                    continue
                self._run_batch(recs, stolen)
        finally:
            store.worker_update(cfg.worker_id, state="stopped")
        return self.summary()

    def summary(self) -> dict:
        """This worker's lifetime counters, as the subprocess prints."""
        return {"worker_id": self.cfg.worker_id,
                "jobs_done": self.jobs_done,
                "kernels_done": self.kernels_done,
                "steals": self.steals, "batches": self.batches,
                "lost_lease": self.lost_lease}

    # ------------------------------------------------------------ batch
    def _run_batch(self, recs: List[JobRecord], stolen: int) -> None:
        """Run one claimed batch through a jobstore-wired simulator.

        The batch sorts by job id — ``recovery_plan`` order — which is
        what pins workers=1 trace-identical to the single-process
        ``SimScheduler.recover`` path."""
        cfg, store = self.cfg, self.store
        live = []
        for rec in sorted(recs, key=lambda r: r.job_id):
            if rec.remaining <= 0:      # claimed a fully-recorded job
                store.record_state(rec.job_id, _js.DONE)
                self.jobs_done += 1
                continue
            live.append(rec)
        if not live:
            return
        specs = [spec_from_record(r) for r in live]
        ids = [r.job_id for r in live]
        bases = [r.completed for r in live]
        profiled = store.load_profiles()
        if profiled is None:
            # no snapshot in the store: measure deterministically so
            # every worker computes the identical profile
            profiled = profile_tasks(specs, T=3, jitter=0.0,
                                     measurement_overhead=0.0)
        plan, self.cfg = cfg.fault_plan, replace(cfg, fault_plan=None)
        stop = threading.Event()
        beat = threading.Thread(target=self._heartbeat, args=(stop,),
                                daemon=True, name="fikit-lease-beat")
        beat.start()
        try:
            sim = SimScheduler(specs, cfg.mode, profiled=profiled,
                               jobstore=_PacedStore(store, cfg.pace_s),
                               job_ids=ids, seq_base=bases,
                               fault_plan=plan)
            sim.run()
        finally:
            stop.set()
            beat.join()
        self.last_sim = sim
        kernels = sum(len(s.kernels) for s in specs)
        self.jobs_done += len(live)
        self.kernels_done += kernels
        self.steals += stolen
        self.batches += 1
        store.worker_update(cfg.worker_id, jobs_done=len(live),
                            kernels_done=kernels, steals=stolen,
                            batches=1)

    def _heartbeat(self, stop: threading.Event) -> None:
        """Renew this worker's leases until the batch ends. A renewal
        that touches zero rows means a peer reaped the leases out from
        under us (heartbeat stalled past ``lease_s``) — recorded on
        ``lost_lease`` for the operator; the store's structural guards
        (``DuplicateCompletion``) stop conflicting writes."""
        while not stop.wait(self.cfg.heartbeat_s):
            if self.store.renew_leases(self.cfg.worker_id,
                                       lease_s=self.cfg.lease_s) == 0:
                self.lost_lease = True


# --------------------------------------------------------- admission seam
class SpecService:
    """Minimal service adapter: a replayable ``TaskSpec`` with the
    ``key``/``priority`` attributes the admission plane reads. What a
    store-backed fleet serves instead of a live JAX model."""

    def __init__(self, spec: TaskSpec):
        self.spec = spec
        self.key = spec.key
        self.priority = spec.priority

    def __repr__(self):
        return f"SpecService({self.key.process!r}, prio={self.priority})"


class StoreBackend:
    """Admission-plane dispatch backend over a ``JobStore``.

    ``AdmissionPlane(backend=...)`` routes admitted groups here instead
    of ``ServingSystem._invoke_async``: ``dispatch`` persists the
    group's spec as a ``submitted`` row stamped with its shard key, a
    watcher thread resolves the ticket callback when a worker drives
    the row terminal, and ``overloaded`` supplies per-worker
    backpressure — the claimable backlog is capped at
    ``per_worker_backlog`` times the number of live workers, so
    admission tightens when the fleet shrinks."""

    def __init__(self, store, *, per_worker_backlog: int = 64,
                 poll_s: float = 0.01, retry_after: float = 0.05):
        self.store = coerce_store(store)
        self.per_worker_backlog = per_worker_backlog
        self.poll_s = poll_s
        self.retry_after = retry_after
        self._watch: Dict[int, Callable] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def dispatch(self, service, on_done, deadline: Optional[float] = None,
                 shard: Optional[str] = None) -> int:
        """Persist one admitted invocation; returns its job id.
        ``on_done(jct, error)`` fires from the watcher thread with the
        store-observed JCT once a worker completes the row, or
        ``(None, None)`` if it was cancelled."""
        spec = service.spec
        jid = self.store.record_submit(
            None, spec.key, spec.priority, n_kernels=len(spec.kernels),
            spec=spec_to_obj(spec), deadline=deadline,
            state=_js.SUBMITTED, qos=shard)
        with self._lock:
            self._watch[jid] = on_done
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._watcher, daemon=True,
                    name="fikit-store-watch")
                self._thread.start()
        return jid

    def overloaded(self, shard: Optional[str] = None) -> Optional[float]:
        """Backpressure probe: seconds-to-retry hint when the (shard's)
        claimable backlog exceeds the live fleet's budget, else None."""
        live = sum(1 for w in self.store.workers()
                   if w["state"] == "running")
        limit = self.per_worker_backlog * max(1, live)
        backlog = self.store.pending_jobs(
            None if shard is None else [shard])
        return self.retry_after if backlog >= limit else None

    def _watcher(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                watched = dict(self._watch)
            if not watched:
                continue
            for rec in self.store.jobs():
                cb = watched.get(rec.job_id)
                if cb is None or rec.state not in _js.TERMINAL_STATES:
                    continue
                with self._lock:
                    self._watch.pop(rec.job_id, None)
                if rec.state == _js.DONE:
                    cb(max(rec.updated_at - rec.submitted_at, 0.0), None)
                else:
                    cb(None, None)      # cancelled — counted like sync

    def close(self) -> None:
        """Stop the watcher thread (pending callbacks never fire)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def enqueue_specs(store, specs: Sequence[TaskSpec],
                  qos: Optional[object] = None) -> List[int]:
    """Persist ``specs`` as claimable rows (the non-admission path a
    bench or test uses to preload a fleet's queue). ``qos`` stamps the
    shard key: a string for all, or a callable ``spec -> key``."""
    store = coerce_store(store)
    ids = []
    for spec in specs:
        key = qos(spec) if callable(qos) else qos
        ids.append(store.record_submit(
            None, spec.key, spec.priority, n_kernels=len(spec.kernels),
            spec=spec_to_obj(spec), deadline=spec.deadline,
            state=_js.SUBMITTED, qos=key))
    return ids


# -------------------------------------------------------------- supervisor
@dataclass
class WorkerSupervisor:
    """Spawn and tend N worker subprocesses over one store file.

    Shard assignment mirrors the placement layer's election seam: with
    ``shard=True`` the store's distinct qos keys are partitioned
    round-robin across workers (worker i gets keys ``i::n``), each
    worker stealing from any shard once its own are empty; with
    ``shard=False`` every worker claims from the whole queue. The
    supervisor registers nothing itself — workers self-register — but
    it holds the start gate: workers launch with ``wait_go`` and only
    begin claiming when every fleet member is registered, so measured
    goodput excludes interpreter start-up."""
    path: str
    n: int = 2
    mode: str = "fikit"
    lease_s: float = 5.0
    heartbeat_s: float = 1.0
    batch: int = 16
    pace_s: float = 0.0
    shard: bool = False
    poll_s: float = 0.02
    procs: List[subprocess.Popen] = field(default_factory=list)
    t_go: Optional[float] = None

    def _shards_of(self, i: int, keys: List[str]) -> Optional[List[str]]:
        if not self.shard or not keys:
            return None
        mine = keys[i::self.n]
        return mine or keys         # more workers than shards: share all

    def start(self, timeout: float = 30.0) -> "WorkerSupervisor":
        """Launch the fleet, wait for every worker to register, then
        open the start gate. Raises on a worker failing to register."""
        from repro_torch.core.jobstore import JobStore
        with JobStore(self.path) as store:
            store.clear_flag(GO_FLAG)
            store.clear_flag(STOP_FLAG)
            keys = store.shards()
        src_root = str(Path(__file__).resolve().parents[2])
        for i in range(self.n):
            cmd = [sys.executable, "-m", "repro_torch.serving.workers",
                   "--jobstore", self.path, "--worker-id", f"w{i}",
                   "--mode", self.mode, "--lease", str(self.lease_s),
                   "--heartbeat", str(self.heartbeat_s),
                   "--batch", str(self.batch), "--pace", str(self.pace_s),
                   "--poll", str(self.poll_s), "--wait-go"]
            mine = self._shards_of(i, keys)
            if mine is not None:
                cmd += ["--shards", ",".join(mine)]
            import os
            env = dict(os.environ)
            env["PYTHONPATH"] = src_root + os.pathsep + env.get(
                "PYTHONPATH", "")
            self.procs.append(subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        deadline = time.monotonic() + timeout
        with JobStore(self.path) as store:
            while time.monotonic() < deadline:
                up = [w for w in store.workers()
                      if w["state"] == "running"]
                if len(up) >= self.n:
                    break
                if any(p.poll() not in (None, 0) for p in self.procs):
                    raise RuntimeError("worker died before registering: "
                                       + self._gather_errors())
                time.sleep(0.01)
            else:
                raise RuntimeError(f"{self.n} workers did not register "
                                   f"within {timeout}s")
            self.t_go = time.time()
            store.set_flag(GO_FLAG, "1")
        return self

    def _gather_errors(self) -> str:
        outs = []
        for p in self.procs:
            if p.poll() not in (None, 0):
                _, err = p.communicate()
                outs.append((err or "").strip()[-500:])
        return " | ".join(outs)

    def wait(self, timeout: float = 120.0) -> List[dict]:
        """Join every worker; returns their printed summaries. Raises
        if any worker exited non-zero (stderr attached)."""
        summaries = []
        deadline = time.monotonic() + timeout
        for p in self.procs:
            left = max(0.1, deadline - time.monotonic())
            out, err = p.communicate(timeout=left)
            if p.returncode != 0:
                raise RuntimeError(f"worker exited {p.returncode}: "
                                   f"{(err or '').strip()[-500:]}")
            summaries.append(json.loads(out.strip().splitlines()[-1]))
        return summaries

    def stop(self) -> None:
        """Graceful drain: set the stop flag (workers finish their
        current batch, then exit)."""
        from repro_torch.core.jobstore import JobStore
        with JobStore(self.path) as store:
            store.set_flag(STOP_FLAG, "1")

    def kill(self) -> None:
        """Hard-stop any worker still running (test teardown)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


# ------------------------------------------------------------ fleet status
def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def fleet_status(store) -> dict:
    """Aggregate the fleet's view of one store: per-worker goodput
    (kernels/s over the worker's registered lifetime), per-class JCT
    percentiles over ``done`` jobs (wall seconds, submit to terminal),
    claimable/leased backlog, and total lease churn."""
    store = coerce_store(store)
    workers = []
    for w in store.workers():
        elapsed = max((w["last_heartbeat"] or 0.0)
                      - (w["started_at"] or 0.0), 1e-9)
        w = dict(w)
        w["goodput_kps"] = w["kernels_done"] / elapsed
        workers.append(w)
    classes: Dict[str, List[float]] = {}
    done = cancelled = 0
    for rec in store.jobs():
        if rec.state == _js.DONE:
            done += 1
            classes.setdefault(rec.qos or "-", []).append(
                max(rec.updated_at - rec.submitted_at, 0.0))
        elif rec.state == _js.CANCELLED:
            cancelled += 1
    per_class = {}
    for name, jcts in sorted(classes.items()):
        jcts.sort()
        per_class[name] = {
            "jobs": len(jcts),
            "jct_mean": sum(jcts) / len(jcts),
            "jct_p50": _pctl(jcts, 0.50), "jct_p99": _pctl(jcts, 0.99)}
    return {"workers": workers, "classes": per_class,
            "jobs_done": done, "jobs_cancelled": cancelled,
            "pending": store.pending_jobs(),
            "leased": store.leased_jobs(),
            "lease_churn": store.lease_churn()}


# -------------------------------------------------------------- entrypoint
def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run ONE worker process against a store file; prints the summary
    counters as JSON on exit. This is what the supervisor spawns."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.workers",
        description="One FIKIT engine worker draining a shared job store")
    ap.add_argument("--jobstore", required=True)
    ap.add_argument("--worker-id", default="w0")
    ap.add_argument("--mode", default="fikit",
                    choices=[m.value for m in Mode])
    ap.add_argument("--lease", type=float, default=5.0)
    ap.add_argument("--heartbeat", type=float, default=1.0)
    ap.add_argument("--poll", type=float, default=0.05)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pace", type=float, default=0.0)
    ap.add_argument("--shards", default=None,
                    help="comma-separated qos shard keys to claim first")
    ap.add_argument("--no-steal", action="store_true")
    ap.add_argument("--no-drain-on-empty", action="store_true",
                    help="poll forever instead of exiting when the "
                         "store empties (stop via the stop flag)")
    ap.add_argument("--wait-go", action="store_true")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="fault injection: hard-crash at this global "
                         "kernel boundary of the first batch")
    args = ap.parse_args(argv)
    shards = (tuple(s for s in args.shards.split(",") if s)
              if args.shards else None)
    plan = (FaultPlan(crash_at=args.crash_at, hard=True)
            if args.crash_at is not None else None)
    cfg = WorkerConfig(
        worker_id=args.worker_id, mode=Mode(args.mode),
        lease_s=args.lease, heartbeat_s=args.heartbeat,
        poll_s=args.poll, batch=args.batch, shards=shards,
        steal=not args.no_steal, pace_s=args.pace,
        drain_on_empty=not args.no_drain_on_empty,
        wait_go=args.wait_go, fault_plan=plan)
    from repro_torch.core.jobstore import JobStore
    with JobStore(args.jobstore) as store:
        summary = EngineWorker(store, cfg).run()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
