"""Durable ops plane: a write-ahead job store for the serving path.

FIKIT's scheduling state (priority queues, holder, gaps, online-learned
SK/SG) lives in process memory; before this module existed a crash lost
every queued request and every learned profile, and an operator had no way
to cancel, pause, or drain a task. ``JobStore`` is the durable record the
engines write THROUGH so a killed process can restart and resume:

- **jobs** — one row per submitted task instance: its ``TaskKey``,
  priority, deadline, total kernel count, an optional serialized kernel
  spec (the simulator's replayable trace; wall-clock payloads are
  callables and re-run from the service definition instead), and a
  lifecycle state (``submitted → running → done`` with ``paused`` /
  ``cancelled`` branches).
- **completions** — one row per finished kernel ``(job, seq)``. This is
  the write-ahead commit point of a kernel boundary: the row is durable
  BEFORE any scheduling side-effect of the completion, so a crash at any
  boundary loses nothing and recovery re-submits exactly the suffix
  ``seq >= watermark``. The primary key makes a duplicated completion a
  structural error (``DuplicateCompletion``), and the contiguity check
  makes a stream-order violation one too (``StreamOrderViolation``) —
  the conservation proof the kill-and-restart sweep rides on.
- **profiles** — the latest snapshot of the (possibly online-refined)
  ``ProfiledData``, in ``repro_torch.core.profile_store`` JSON form including
  EMA counters and interference coefficients, so recovery resumes
  scheduling with the learned SK/SG intact.
- **controls** — a queue of operator verbs (``cancel``/``pause``/
  ``resume``/``drain``) written by the CLI (``repro_torch.launch.serve``) and
  consumed by a live serving process sharing the store file.
- **workers** — one row per registered engine worker process (see
  ``repro_torch.serving.workers``): heartbeat timestamp, lifecycle state, and
  drained-work counters, the raw material of the ``serve workers
  status`` fleet view.

**Leases** (the multi-process serving contract): a worker claims
``submitted`` jobs by atomically stamping ``owner`` + ``lease_expires``
inside one ``BEGIN IMMEDIATE`` transaction (``claim_jobs``), renews the
lease while executing (``renew_leases``, the heartbeat), and any
surviving worker may ``reap_expired`` a lease whose deadline passed —
the job returns to ``submitted`` with its completion watermark intact,
so the next claimant re-runs exactly the remaining kernel suffix (the
same ``spec_from_record`` suffix logic crash recovery uses). The
``completions`` primary key keeps reclamation honest: a duplicated
kernel after a botched reclaim is a structural
``DuplicateCompletion``, not silent double work.

Backends: a file path opens SQLite in WAL mode with per-statement
durability (autocommit); ``JobStore.memory()`` opens ``:memory:`` — same
schema and API, nothing touches disk — for tests and for engines that
want conservation checking without persistence. All methods are
thread-safe (one internal lock; SQLite connection shared); file stores
are additionally safe to share across processes (WAL + SQLite's
busy-wait, which is how N workers drain one queue).

The standing contract: a store attached to an engine only OBSERVES —
recording submissions and completions never changes a scheduling
decision, pinned by randomized store-attached-vs-absent differential
cases in ``tests/test_recovery.py``.

Write-order contract (relied on by every recovery/reclaim path):

1. ``record_submit`` happens BEFORE the submitting clock starts — a
   crash before a late arrival cannot lose the job (submit-ahead);
2. ``record_completion`` is durable BEFORE any scheduling side-effect
   of that kernel boundary (write-ahead) — a crash at boundary ``b``
   leaves exactly ``b + 1`` rows and recovery re-submits the suffix;
3. terminal ``record_state`` (``done``/``cancelled``) comes LAST and
   also releases any lease, so a job can never be simultaneously
   finished and claimable.
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.profile_store import (_kid_from_json, _kid_to_json,
                                      profiles_from_obj, profiles_to_obj)
from repro_torch.core.profiler import ProfiledData
from repro_torch.core.task import TaskKey, TaskSpec, TraceKernel

# ---------------------------------------------------------------- lifecycle
#: job lifecycle states
SUBMITTED = "submitted"
RUNNING = "running"
PAUSED = "paused"
CANCELLED = "cancelled"
DONE = "done"
STATES = (SUBMITTED, RUNNING, PAUSED, CANCELLED, DONE)
#: states a job can never leave
TERMINAL_STATES = (CANCELLED, DONE)
#: operator verbs accepted by the control queue
CONTROL_VERBS = ("cancel", "pause", "resume", "drain")

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id       INTEGER PRIMARY KEY,
    process      TEXT NOT NULL,
    args         TEXT NOT NULL,
    priority     INTEGER NOT NULL,
    n_kernels    INTEGER NOT NULL,
    deadline     REAL,
    spec         TEXT,
    state        TEXT NOT NULL,
    submitted_at REAL,
    updated_at   REAL,
    qos          TEXT,
    owner        TEXT,
    lease_expires REAL,
    reclaims     INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS workers (
    worker_id      TEXT PRIMARY KEY,
    state          TEXT NOT NULL,
    started_at     REAL,
    last_heartbeat REAL,
    jobs_done      INTEGER NOT NULL DEFAULT 0,
    kernels_done   INTEGER NOT NULL DEFAULT 0,
    steals         INTEGER NOT NULL DEFAULT 0,
    reaped         INTEGER NOT NULL DEFAULT 0,
    batches        INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS completions (
    job_id       INTEGER NOT NULL,
    seq          INTEGER NOT NULL,
    completed_at REAL,
    PRIMARY KEY (job_id, seq)
) WITHOUT ROWID;
CREATE TABLE IF NOT EXISTS profiles (
    id         INTEGER PRIMARY KEY CHECK (id = 1),
    payload    TEXT NOT NULL,
    updated_at REAL
);
CREATE TABLE IF NOT EXISTS controls (
    ctl_id     INTEGER PRIMARY KEY AUTOINCREMENT,
    verb       TEXT NOT NULL,
    job_id     INTEGER,
    arg        TEXT,
    consumed   INTEGER NOT NULL DEFAULT 0,
    created_at REAL
);
CREATE TABLE IF NOT EXISTS meta (
    k TEXT PRIMARY KEY,
    v TEXT
);
"""

SCHEMA_VERSION = "1"


class JobStoreError(RuntimeError):
    """Base class for job-store integrity errors."""


class UnknownJob(JobStoreError):
    pass


class DuplicateCompletion(JobStoreError):
    """The same (job, seq) kernel completion was recorded twice — a
    request would have executed twice after recovery."""


class StreamOrderViolation(JobStoreError):
    """A completion arrived out of stream order — kernel ``seq`` finished
    before ``seq - 1`` did, which the serial-device + stream-order
    invariants make impossible unless an engine is broken."""


@dataclass
class JobRecord:
    """One job row, hydrated (``completed`` is the stream watermark: the
    number of contiguously completed kernels).

    ``qos`` is the shard key stamped at submit time (a QoS class or
    service name — see ``repro_torch.serving.workers``); ``owner`` /
    ``lease_expires`` describe the live lease when a worker holds the
    job; ``reclaims`` counts how many times an expired lease was reaped
    (the per-job share of fleet lease churn)."""
    job_id: int
    key: TaskKey
    priority: int
    n_kernels: int
    completed: int
    state: str
    deadline: Optional[float] = None
    spec: Optional[dict] = None
    submitted_at: float = 0.0
    updated_at: float = 0.0
    qos: Optional[str] = None
    owner: Optional[str] = None
    lease_expires: Optional[float] = None
    reclaims: int = 0

    @property
    def remaining(self) -> int:
        """Kernels not yet completed (``n_kernels`` minus watermark)."""
        return self.n_kernels - self.completed

    @property
    def incomplete(self) -> bool:
        """True while the job can still make progress (not terminal)."""
        return self.state not in TERMINAL_STATES


# ------------------------------------------------------- spec serialization
def spec_to_obj(spec: TaskSpec) -> dict:
    """Serialize a simulator ``TaskSpec``'s replayable parts (kernel
    trace, client model). Key/priority/deadline live in job columns."""
    return {
        "kernels": [[_kid_to_json(k.kid), k.duration, k.gap_after, k.kclass]
                    for k in spec.kernels],
        "max_inflight": spec.max_inflight,
        "arrival": spec.arrival,
    }


def spec_from_record(rec: JobRecord) -> TaskSpec:
    """Rebuild the REMAINING TaskSpec for an incomplete job: the kernel
    suffix from the completion watermark on, arriving immediately. The
    caller pairs it with ``rec.completed`` as the seq base so recovered
    completions keep their original stream indices."""
    if rec.spec is None:
        raise JobStoreError(f"job {rec.job_id} has no replayable spec "
                            f"(wall-clock jobs re-run from the service)")
    kernels = [TraceKernel(_kid_from_json(kj), dur, gap, kclass=kc)
               for kj, dur, gap, kc in rec.spec["kernels"]]
    return TaskSpec(rec.key, rec.priority, kernels[rec.completed:],
                    arrival=0.0, max_inflight=rec.spec["max_inflight"],
                    deadline=rec.deadline)


class JobStore:
    """SQLite-backed write-ahead record of jobs, completions, learned
    profiles, and operator control requests. See module docstring."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._lock = threading.RLock()
        # autocommit (isolation_level=None): every INSERT is its own
        # durable transaction — the write-ahead property the recovery
        # sweep depends on
        self._db = sqlite3.connect(path, isolation_level=None,
                                   check_same_thread=False)
        self._db.executescript(_SCHEMA)
        self._migrate()
        if path != ":memory:":
            # WAL keeps concurrent CLI readers (status verb) from
            # blocking the serving process's boundary writes
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute(
            "INSERT OR IGNORE INTO meta (k, v) VALUES ('schema', ?)",
            (SCHEMA_VERSION,))

    def _migrate(self) -> None:
        """Bring a store created by an older schema up to date (``CREATE
        TABLE IF NOT EXISTS`` never adds columns to an existing file)."""
        have = {row[1] for row in
                self._db.execute("PRAGMA table_info(jobs)").fetchall()}
        for col, decl in (("qos", "TEXT"), ("owner", "TEXT"),
                          ("lease_expires", "REAL"),
                          ("reclaims", "INTEGER NOT NULL DEFAULT 0")):
            if col not in have:
                self._db.execute(f"ALTER TABLE jobs ADD COLUMN {col} {decl}")

    @classmethod
    def memory(cls) -> "JobStore":
        """In-memory backend: same schema/API, no disk, no durability —
        for tests and conservation-checking without persistence."""
        return cls(":memory:")

    def close(self) -> None:
        """Close the underlying SQLite connection."""
        with self._lock:
            self._db.close()

    def __enter__(self) -> "JobStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- writes
    def record_submit(self, job_id: Optional[int], key: TaskKey,
                      priority: int, *, n_kernels: int,
                      spec: Optional[dict] = None,
                      deadline: Optional[float] = None,
                      state: str = RUNNING,
                      qos: Optional[str] = None,
                      at: Optional[float] = None) -> int:
        """Record a job submission; returns its id. ``job_id=None``
        allocates the next id. An existing row (a recovery re-submission)
        is NOT overwritten — its original spec, kernel count, and
        completions survive; only its state advances to ``state``.
        ``qos`` stamps the shard key worker fleets route claims by
        (``state=SUBMITTED`` puts the job on the claimable queue rather
        than marking it already running)."""
        now = time.time() if at is None else at
        with self._lock:
            if job_id is not None:
                cur = self._db.execute(
                    "SELECT 1 FROM jobs WHERE job_id = ?", (job_id,))
                if cur.fetchone() is not None:
                    self._db.execute(
                        "UPDATE jobs SET state = ?, updated_at = ? "
                        "WHERE job_id = ?", (state, now, job_id))
                    return job_id
            cur = self._db.execute(
                "INSERT INTO jobs (job_id, process, args, priority, "
                "n_kernels, deadline, spec, state, submitted_at, "
                "updated_at, qos) VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (job_id, key.process, json.dumps(list(key.args)), priority,
                 n_kernels, deadline,
                 None if spec is None else json.dumps(spec),
                 state, now, now, qos))
            return job_id if job_id is not None else cur.lastrowid

    def record_state(self, job_id: int, state: str,
                     at: Optional[float] = None) -> None:
        """Advance a job's lifecycle state. A terminal state (``done``/
        ``cancelled``) also releases any lease — a finished job can
        never be simultaneously claimable."""
        if state not in STATES:
            raise ValueError(f"unknown job state {state!r} "
                             f"(known: {list(STATES)})")
        now = time.time() if at is None else at
        release = (", owner = NULL, lease_expires = NULL"
                   if state in TERMINAL_STATES else "")
        with self._lock:
            cur = self._db.execute(
                f"UPDATE jobs SET state = ?, updated_at = ?{release} "
                f"WHERE job_id = ?", (state, now, job_id))
            if cur.rowcount == 0:
                raise UnknownJob(f"job {job_id} not in store")

    def record_completion(self, job_id: int, seq: int,
                          at: Optional[float] = None) -> int:
        """Durably record kernel ``seq`` of ``job_id`` as completed; the
        write-ahead commit of a kernel boundary. Enforces stream
        contiguity (``seq`` must be the current watermark) and raises
        ``DuplicateCompletion`` / ``StreamOrderViolation`` otherwise.
        Returns the new watermark."""
        now = time.time() if at is None else at
        with self._lock:
            wm = self._watermark(job_id)
            if seq < wm:
                raise DuplicateCompletion(
                    f"job {job_id} kernel {seq} already recorded "
                    f"(watermark {wm}) — a request would run twice")
            if seq > wm:
                raise StreamOrderViolation(
                    f"job {job_id} kernel {seq} completed before "
                    f"kernel {wm} — stream order broken")
            try:
                self._db.execute(
                    "INSERT INTO completions (job_id, seq, completed_at) "
                    "VALUES (?, ?, ?)", (job_id, seq, now))
            except sqlite3.IntegrityError as e:  # pragma: no cover
                raise DuplicateCompletion(
                    f"job {job_id} kernel {seq} already recorded") from e
            return wm + 1

    def reset_completions(self, job_id: int) -> None:
        """Forget a job's completions (wall-clock recovery re-runs an
        incomplete invocation from scratch — request-level at-least-once;
        the simulator's kernel-exact path never needs this)."""
        with self._lock:
            self._db.execute("DELETE FROM completions WHERE job_id = ?",
                             (job_id,))

    # --------------------------------------------------------------- reads
    def _watermark(self, job_id: int) -> int:
        row = self._db.execute(
            "SELECT MAX(seq) FROM completions WHERE job_id = ?",
            (job_id,)).fetchone()
        return 0 if row[0] is None else row[0] + 1

    def _hydrate(self, row) -> JobRecord:
        (job_id, process, args, priority, n_kernels, deadline, spec,
         state, submitted_at, updated_at, qos, owner, lease_expires,
         reclaims) = row
        return JobRecord(
            job_id=job_id,
            key=TaskKey(process, tuple(json.loads(args))),
            priority=priority, n_kernels=n_kernels,
            completed=self._watermark(job_id), state=state,
            deadline=deadline,
            spec=None if spec is None else json.loads(spec),
            submitted_at=submitted_at or 0.0,
            updated_at=updated_at or 0.0,
            qos=qos, owner=owner, lease_expires=lease_expires,
            reclaims=reclaims or 0)

    _JOB_COLS = ("job_id, process, args, priority, n_kernels, deadline, "
                 "spec, state, submitted_at, updated_at, qos, owner, "
                 "lease_expires, reclaims")

    def _select_jobs(self, ids: Sequence[int]) -> List[JobRecord]:
        if not ids:
            return []
        marks = ",".join("?" * len(ids))
        rows = self._db.execute(
            f"SELECT {self._JOB_COLS} FROM jobs "
            f"WHERE job_id IN ({marks}) ORDER BY priority, job_id",
            tuple(ids)).fetchall()
        return [self._hydrate(r) for r in rows]

    def job(self, job_id: int) -> JobRecord:
        with self._lock:
            row = self._db.execute(
                f"SELECT {self._JOB_COLS} FROM jobs WHERE job_id = ?",
                (job_id,)).fetchone()
            if row is None:
                raise UnknownJob(f"job {job_id} not in store")
            return self._hydrate(row)

    def jobs(self, states: Optional[Sequence[str]] = None
             ) -> List[JobRecord]:
        with self._lock:
            rows = self._db.execute(
                f"SELECT {self._JOB_COLS} FROM jobs "
                f"ORDER BY job_id").fetchall()
            recs = [self._hydrate(r) for r in rows]
        if states is not None:
            recs = [r for r in recs if r.state in states]
        return recs

    def incomplete_jobs(self, include_paused: bool = False
                        ) -> List[JobRecord]:
        """Jobs a restart must resume: not done, not cancelled. Paused
        jobs stay paused across a restart (an explicit ``resume`` verb
        re-admits them) unless ``include_paused``."""
        skip = set(TERMINAL_STATES)
        if not include_paused:
            skip.add(PAUSED)
        return [r for r in self.jobs() if r.state not in skip]

    def completions(self, job_id: int) -> List[int]:
        with self._lock:
            rows = self._db.execute(
                "SELECT seq FROM completions WHERE job_id = ? "
                "ORDER BY seq", (job_id,)).fetchall()
        return [r[0] for r in rows]

    def watermark(self, job_id: int) -> int:
        with self._lock:
            return self._watermark(job_id)

    # ------------------------------------------------------------ recovery
    def recovery_plan(self, include_paused: bool = False
                      ) -> Tuple[List[TaskSpec], List[int], List[int]]:
        """Build the simulator recovery inputs: the remaining ``TaskSpec``
        suffix per incomplete job, the job ids to keep recording under,
        and the per-job seq bases (completion watermarks). Jobs without a
        replayable spec (wall-clock invocations) are skipped — the serving
        layer re-runs those from the service definition."""
        specs, ids, bases = [], [], []
        for rec in self.incomplete_jobs(include_paused=include_paused):
            if rec.spec is None or rec.remaining <= 0:
                continue
            specs.append(spec_from_record(rec))
            ids.append(rec.job_id)
            bases.append(rec.completed)
        return specs, ids, bases

    # -------------------------------------------------------------- leases
    def claim_jobs(self, worker: str, *, limit: int = 1,
                   lease_s: float = 5.0,
                   shards: Optional[Sequence[str]] = None,
                   now: Optional[float] = None) -> List[JobRecord]:
        """Atomically claim up to ``limit`` replayable ``submitted`` jobs
        for ``worker``: stamp ``owner`` + ``lease_expires`` and advance
        them to ``running`` inside one ``BEGIN IMMEDIATE`` transaction,
        so two workers sharing the store file can never claim the same
        job. Selection is strict-priority (then submission order) —
        gold-class work is always claimed before bronze. ``shards``
        restricts the claim to jobs whose ``qos`` shard key is in the
        sequence (None = any shard, the work-stealing fallback).

        A row whose lease is still live is NOT claimable even while its
        state reads ``submitted`` — the owning worker's simulator
        write-ahead parks claimed jobs in ``submitted`` until their
        arrival event fires, and only lease expiry (not that transient)
        may hand work to another worker.

        Returns the claimed rows, hydrated; an empty list when nothing
        matched."""
        if limit < 1:
            raise ValueError(f"claim limit must be >= 1, got {limit}")
        t = time.time() if now is None else now
        where = ("state = ? AND spec IS NOT NULL "
                 "AND (owner IS NULL OR lease_expires < ?)")
        params: list = [SUBMITTED, t]
        if shards is not None:
            shards = list(shards)
            if not shards:
                return []
            where += (" AND qos IN ("
                      + ",".join("?" * len(shards)) + ")")
            params += shards
        with self._lock:
            self._db.execute("BEGIN IMMEDIATE")
            try:
                rows = self._db.execute(
                    f"SELECT {self._JOB_COLS} FROM jobs WHERE {where} "
                    f"ORDER BY priority, job_id LIMIT ?",
                    (*params, limit)).fetchall()
                ids = [r[0] for r in rows]
                if ids:
                    # claiming over a stale owner IS a reclaim (the
                    # crash-before-arrival window leaves rows submitted
                    # with an expired lease; no reap pass sees them)
                    marks = ",".join("?" * len(ids))
                    self._db.execute(
                        f"UPDATE jobs SET reclaims = reclaims + (CASE "
                        f"WHEN owner IS NOT NULL AND owner != ? THEN 1 "
                        f"ELSE 0 END), owner = ?, lease_expires = ?, "
                        f"state = ?, updated_at = ? "
                        f"WHERE job_id IN ({marks})",
                        (worker, worker, t + lease_s, RUNNING, t, *ids))
                self._db.execute("COMMIT")
            except BaseException:
                self._db.execute("ROLLBACK")
                raise
            return self._select_jobs(ids)

    def renew_leases(self, worker: str, lease_s: float = 5.0,
                     now: Optional[float] = None) -> int:
        """Heartbeat: extend every lease ``worker`` currently holds (and
        refresh its worker-table heartbeat). Returns how many leases
        were renewed — 0 tells a worker its leases were reaped out from
        under it (it should stop writing and re-claim)."""
        t = time.time() if now is None else now
        with self._lock:
            cur = self._db.execute(
                "UPDATE jobs SET lease_expires = ? "
                "WHERE owner = ? AND state = ?",
                (t + lease_s, worker, RUNNING))
            self._db.execute(
                "UPDATE workers SET last_heartbeat = ? WHERE worker_id = ?",
                (t, worker))
            return cur.rowcount

    def reap_expired(self, by: Optional[str] = None,
                     now: Optional[float] = None) -> List[JobRecord]:
        """Reclaim every job whose lease expired: back to ``submitted``
        with the lease cleared and ``reclaims`` bumped, so a surviving
        worker's next ``claim_jobs`` re-runs exactly the remaining
        kernel suffix (completions — the watermark — are untouched).
        ``by`` credits the reap to a worker's fleet-status counters.
        Returns the reclaimed rows (post-reap state)."""
        t = time.time() if now is None else now
        with self._lock:
            self._db.execute("BEGIN IMMEDIATE")
            try:
                rows = self._db.execute(
                    f"SELECT {self._JOB_COLS} FROM jobs "
                    f"WHERE state = ? AND owner IS NOT NULL "
                    f"AND lease_expires < ?", (RUNNING, t)).fetchall()
                ids = [r[0] for r in rows]
                if ids:
                    marks = ",".join("?" * len(ids))
                    self._db.execute(
                        f"UPDATE jobs SET state = ?, owner = NULL, "
                        f"lease_expires = NULL, reclaims = reclaims + 1, "
                        f"updated_at = ? WHERE job_id IN ({marks})",
                        (SUBMITTED, t, *ids))
                    if by is not None:
                        self._db.execute(
                            "UPDATE workers SET reaped = reaped + ? "
                            "WHERE worker_id = ?", (len(ids), by))
                self._db.execute("COMMIT")
            except BaseException:
                self._db.execute("ROLLBACK")
                raise
            return self._select_jobs(ids)

    def pending_jobs(self, shards: Optional[Sequence[str]] = None,
                     now: Optional[float] = None) -> int:
        """How many replayable jobs are claimable right now (``submitted``
        state, no live lease), optionally restricted to ``shards`` — the
        backpressure probe and the drain-on-empty check. Matches the
        ``claim_jobs`` predicate exactly."""
        t = time.time() if now is None else now
        where = ("state = ? AND spec IS NOT NULL "
                 "AND (owner IS NULL OR lease_expires < ?)")
        params: list = [SUBMITTED, t]
        if shards is not None:
            shards = list(shards)
            if not shards:
                return 0
            where += " AND qos IN (" + ",".join("?" * len(shards)) + ")"
            params += shards
        with self._lock:
            row = self._db.execute(
                f"SELECT COUNT(*) FROM jobs WHERE {where}",
                params).fetchone()
        return row[0]

    def leased_jobs(self) -> int:
        """How many non-terminal jobs are currently held under a worker
        lease (live or expired — an expired lease still means a reap or
        re-claim is owed, so a draining sibling must not exit yet)."""
        with self._lock:
            row = self._db.execute(
                "SELECT COUNT(*) FROM jobs WHERE owner IS NOT NULL "
                "AND state NOT IN (?, ?)", TERMINAL_STATES).fetchone()
        return row[0]

    def lease_churn(self) -> int:
        """Total lease reclaims across all jobs (fleet churn metric)."""
        with self._lock:
            row = self._db.execute(
                "SELECT COALESCE(SUM(reclaims), 0) FROM jobs").fetchone()
        return row[0]

    def shards(self) -> List[str]:
        """Distinct shard keys stamped on stored jobs (sorted), for a
        supervisor partitioning shards across workers."""
        with self._lock:
            rows = self._db.execute(
                "SELECT DISTINCT qos FROM jobs "
                "WHERE qos IS NOT NULL ORDER BY qos").fetchall()
        return [r[0] for r in rows]

    # ------------------------------------------------------------- workers
    def register_worker(self, worker: str, state: str = "running",
                        now: Optional[float] = None) -> None:
        """Create (or reset) a worker's fleet-status row."""
        t = time.time() if now is None else now
        with self._lock:
            self._db.execute(
                "INSERT INTO workers (worker_id, state, started_at, "
                "last_heartbeat) VALUES (?, ?, ?, ?) "
                "ON CONFLICT (worker_id) DO UPDATE SET state = excluded."
                "state, started_at = excluded.started_at, last_heartbeat "
                "= excluded.last_heartbeat, jobs_done = 0, kernels_done "
                "= 0, steals = 0, reaped = 0, batches = 0",
                (worker, state, t, t))

    def worker_update(self, worker: str, state: Optional[str] = None,
                      jobs_done: int = 0, kernels_done: int = 0,
                      steals: int = 0, batches: int = 0,
                      now: Optional[float] = None) -> None:
        """Accumulate a worker's drained-work counters (deltas) and
        optionally advance its lifecycle state."""
        t = time.time() if now is None else now
        with self._lock:
            self._db.execute(
                "UPDATE workers SET jobs_done = jobs_done + ?, "
                "kernels_done = kernels_done + ?, steals = steals + ?, "
                "batches = batches + ?, last_heartbeat = ? "
                "WHERE worker_id = ?",
                (jobs_done, kernels_done, steals, batches, t, worker))
            if state is not None:
                self._db.execute(
                    "UPDATE workers SET state = ? WHERE worker_id = ?",
                    (state, worker))

    def workers(self) -> List[dict]:
        """All registered workers' fleet-status rows, as dicts."""
        cols = ("worker_id", "state", "started_at", "last_heartbeat",
                "jobs_done", "kernels_done", "steals", "reaped", "batches")
        with self._lock:
            rows = self._db.execute(
                f"SELECT {', '.join(cols)} FROM workers "
                f"ORDER BY worker_id").fetchall()
        return [dict(zip(cols, r)) for r in rows]

    # --------------------------------------------------------------- flags
    def set_flag(self, key: str, value: str) -> None:
        """Set a cross-process coordination flag (e.g. the supervisor's
        ``workers_go`` start gate or the ``workers_stop`` drain signal).
        Flags live in the meta table under a ``flag:`` namespace."""
        with self._lock:
            self._db.execute(
                "INSERT INTO meta (k, v) VALUES (?, ?) "
                "ON CONFLICT (k) DO UPDATE SET v = excluded.v",
                (f"flag:{key}", value))

    def flag(self, key: str) -> Optional[str]:
        """Read a coordination flag; None when never set/cleared."""
        with self._lock:
            row = self._db.execute(
                "SELECT v FROM meta WHERE k = ?",
                (f"flag:{key}",)).fetchone()
        return None if row is None else row[0]

    def clear_flag(self, key: str) -> None:
        """Delete a coordination flag."""
        with self._lock:
            self._db.execute("DELETE FROM meta WHERE k = ?",
                             (f"flag:{key}",))

    # ------------------------------------------------------------ profiles
    def snapshot_profiles(self, data: ProfiledData,
                          at: Optional[float] = None) -> None:
        """Checkpoint the (possibly online-refined) profile state. One
        snapshot row, overwritten — the store keeps the LATEST learned
        SK/SG, which is what recovery resumes with."""
        now = time.time() if at is None else at
        payload = json.dumps(profiles_to_obj(data))
        with self._lock:
            self._db.execute(
                "INSERT INTO profiles (id, payload, updated_at) "
                "VALUES (1, ?, ?) ON CONFLICT (id) DO UPDATE SET "
                "payload = excluded.payload, "
                "updated_at = excluded.updated_at", (payload, now))

    def load_profiles(self, cold_start: bool = False
                      ) -> Optional[ProfiledData]:
        """The latest profile snapshot, or None if never checkpointed."""
        with self._lock:
            row = self._db.execute(
                "SELECT payload FROM profiles WHERE id = 1").fetchone()
        if row is None:
            return None
        return profiles_from_obj(json.loads(row[0]), cold_start=cold_start)

    # ------------------------------------------------------------ controls
    def request_control(self, verb: str, job_id: Optional[int] = None,
                        arg: Optional[str] = None,
                        at: Optional[float] = None) -> int:
        """Enqueue an operator verb for the serving process sharing this
        store (the CLI's side of the ops plane)."""
        if verb not in CONTROL_VERBS:
            raise ValueError(f"unknown control verb {verb!r} "
                             f"(known: {list(CONTROL_VERBS)})")
        now = time.time() if at is None else at
        with self._lock:
            cur = self._db.execute(
                "INSERT INTO controls (verb, job_id, arg, created_at) "
                "VALUES (?, ?, ?, ?)", (verb, job_id, arg, now))
            return cur.lastrowid

    def pop_controls(self) -> List[Tuple[str, Optional[int], Optional[str]]]:
        """Consume all pending control requests in submission order."""
        with self._lock:
            rows = self._db.execute(
                "SELECT ctl_id, verb, job_id, arg FROM controls "
                "WHERE consumed = 0 ORDER BY ctl_id").fetchall()
            if rows:
                self._db.execute(
                    "UPDATE controls SET consumed = 1 WHERE ctl_id <= ? "
                    "AND consumed = 0", (rows[-1][0],))
        return [(v, j, a) for _, v, j, a in rows]

    # ---------------------------------------------------------- durability
    def checkpoint(self) -> None:
        """Fold the WAL into the main database file (drain/shutdown)."""
        with self._lock:
            if self.path != ":memory:":
                self._db.execute("PRAGMA wal_checkpoint(TRUNCATE)")


def coerce_store(spec) -> Optional[JobStore]:
    """Normalize an engine's ``jobstore=`` argument: None -> None, a path
    string -> opened file store, a ``JobStore`` — or any object exposing
    the store write interface, like a worker's pacing proxy -> itself."""
    if spec is None:
        return None
    if isinstance(spec, JobStore):
        return spec
    if isinstance(spec, (str, os.PathLike)):
        return JobStore(os.fspath(spec))
    if (hasattr(spec, "record_submit")
            and hasattr(spec, "record_completion")):
        return spec
    raise TypeError(f"jobstore= expects None/path/JobStore, got {spec!r}")
