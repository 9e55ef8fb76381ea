"""Measurement phase (paper §3.2, Fig 6): per-kernel execution time and
inter-kernel idle (gap) collection over T runs, reduced to the SK / SG
statistics with Kronecker-delta means:

    SK_j = mean of K_{ID_{t,i}} over all (t, i) with ID_{t,i} == j
    SG_j = mean of G_{ID_{t,i}} over all (t, i < N_t) with ID_{t,i} == j

Beyond the paper's strictly-offline two-phase design, ``TaskProfile`` and
``ProfiledData`` also carry the state the ONLINE measurement loop
(``repro_torch.core.online.OnlineMeasurement``) refines during sharing-mode
execution: per-kernel observation counters (``obs_count``/``gap_obs_count``),
the EMA smoothing factor a profile was last updated with (``ema_alpha``),
and an optional cold-start estimator that serves a provisional duration for
never-profiled kernels instead of the ``-1.0`` sentinel.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.interference import COMPUTE_BOUND
from repro_torch.core.kernel_id import KernelID
from repro_torch.core.task import TaskKey


@dataclass
class TaskProfile:
    """Profiled statistics for one TaskKey (the paper's
    ``TaskKey = (SK, SG)`` output).

    ``runs`` counts offline measured runs; ``obs_count``/``gap_obs_count``
    count ONLINE observations folded into each kernel's SK/SG entry (empty
    for a purely offline profile), and ``ema_alpha`` records the smoothing
    factor of the last online update (None when never updated online).
    Together with the current SK/SG values these fields are the complete
    EMA state, so a profile refined online round-trips losslessly through
    ``repro_torch.core.profile_store``.

    ``kclass`` maps a kernel to its resource class ("compute"/"memory",
    see ``repro_torch.core.interference``); kernels absent from it are treated
    as compute-bound, which makes pre-classification profiles load
    cleanly."""
    key: TaskKey
    SK: Dict[KernelID, float] = field(default_factory=dict)
    SG: Dict[KernelID, float] = field(default_factory=dict)
    runs: int = 0
    obs_count: Dict[KernelID, int] = field(default_factory=dict)
    gap_obs_count: Dict[KernelID, int] = field(default_factory=dict)
    ema_alpha: Optional[float] = None
    kclass: Dict[KernelID, str] = field(default_factory=dict)

    @property
    def unique_ids(self):
        return set(self.SK)

    @property
    def online_observations(self) -> int:
        """Total online duration observations folded into this profile."""
        return sum(self.obs_count.values())

    def predict_duration(self, kid: KernelID) -> float:
        return self.SK.get(kid, -1.0)

    def predict_gap(self, kid: KernelID) -> float:
        return self.SG.get(kid, 0.0)

    def clone(self) -> "TaskProfile":
        """Shallow-copy the per-kernel dicts (KernelIDs are interned and
        values are floats/ints, so a per-dict copy is a full copy)."""
        return TaskProfile(key=self.key, SK=dict(self.SK), SG=dict(self.SG),
                           runs=self.runs, obs_count=dict(self.obs_count),
                           gap_obs_count=dict(self.gap_obs_count),
                           ema_alpha=self.ema_alpha,
                           kclass=dict(self.kclass))


class Profiler:
    """Collects per-run kernel records and emits SK/SG statistics.

    Usage per measured run::

        prof.start_run()
        prof.record(kid, duration)          # kernel executed
        prof.record_gap(gap)                # idle observed after last kid
        prof.end_run()
        ...
        profile = prof.statistics()
    """

    def __init__(self, key: TaskKey):
        self.key = key
        self._runs: List[List[Tuple[KernelID, float, Optional[float]]]] = []
        self._cur: Optional[List] = None
        self._kclass: Dict[KernelID, str] = {}

    # ------------------------------------------------------------- recording
    def start_run(self) -> None:
        if self._cur is not None:
            raise RuntimeError("previous run not ended")
        self._cur = []

    def record(self, kid: KernelID, duration: float,
               kclass: Optional[str] = None) -> None:
        if self._cur is None:
            raise RuntimeError("start_run() first")
        self._cur.append([kid, float(duration), None])
        if kclass is not None:
            self._kclass[kid] = kclass    # last observation wins

    def record_gap(self, gap: float) -> None:
        """Gap after the most recently recorded kernel."""
        if self._cur is None or not self._cur:
            raise RuntimeError("no kernel to attach gap to")
        self._cur[-1][2] = float(gap)

    def end_run(self) -> None:
        if self._cur is None:
            raise RuntimeError("start_run() first")
        # last kernel of a run has no following gap (paper: N_t - 1 gaps)
        if self._cur:
            self._cur[-1][2] = None
        self._runs.append(self._cur)
        self._cur = None

    @property
    def num_runs(self) -> int:
        return len(self._runs)

    # ------------------------------------------------------------ statistics
    def statistics(self) -> TaskProfile:
        ksum: Dict[KernelID, float] = {}
        kcnt: Dict[KernelID, int] = {}
        gsum: Dict[KernelID, float] = {}
        gcnt: Dict[KernelID, int] = {}
        for run in self._runs:
            for kid, dur, gap in run:
                ksum[kid] = ksum.get(kid, 0.0) + dur
                kcnt[kid] = kcnt.get(kid, 0) + 1
                if gap is not None:
                    gsum[kid] = gsum.get(kid, 0.0) + gap
                    gcnt[kid] = gcnt.get(kid, 0) + 1
        prof = TaskProfile(key=self.key, runs=len(self._runs))
        prof.SK = {k: ksum[k] / kcnt[k] for k in ksum}
        prof.SG = {k: gsum[k] / gcnt[k] for k in gsum}
        prof.kclass = dict(self._kclass)
        return prof


class ProfiledData:
    """The scheduler's global loaded profile (Algorithm 1 ``ProfiledData``):
    TaskKey -> TaskProfile.

    Predictions are served from flat ``(TaskKey, KernelID) -> float`` dicts
    rebuilt on ``load()``, so the per-decision hot path
    (``predict_duration``/``predict_gap``) is ONE dict probe instead of a
    TaskKey lookup followed by a KernelID lookup. ``version`` increments on
    every ``load()`` — the priority-queue duration index keys its cache
    validity on it. Mutating a ``TaskProfile``'s SK/SG dicts after loading
    is not seen until the profile is loaded again.

    Cold start
    ----------
    With ``cold_start=False`` (the default, the paper's behavior) an
    unprofiled ``(TaskKey, KernelID)`` predicts the ``-1.0`` sentinel,
    which excludes the kernel from gap filling entirely — a cold task is
    invisible to FIKIT until someone profiles it. ``cold_start=True`` (or
    ``enable_cold_start()``) serves a PROVISIONAL duration instead: the
    mean SK of the task's own profiled kernels when the TaskKey is known,
    falling back to the global mean over every loaded SK entry, and only
    then to ``-1.0`` (nothing loaded at all — no basis for an estimate).
    Estimates are deterministic functions of the loaded state, recomputed
    on ``load()``, so the queue duration index (cached per ``version``)
    and the O(n) reference scans always agree on them. ``predictions
    served cold`` are counted in ``cold_predictions``. Gap predictions are
    NOT cold-started: a fabricated gap would open fake fill windows,
    whereas a missing gap (0.0) merely skips an optimization.
    """

    def __init__(self, cold_start: bool = False):
        self._by_key: Dict[TaskKey, TaskProfile] = {}
        self._sk: Dict[Tuple[TaskKey, KernelID], float] = {}
        self._sg: Dict[Tuple[TaskKey, KernelID], float] = {}
        self._class: Dict[Tuple[TaskKey, KernelID], str] = {}
        self._cold_start = cold_start
        self._key_mean: Dict[TaskKey, float] = {}
        self._sk_sum = 0.0
        self._sk_cnt = 0
        self.cold_predictions = 0
        self.version = 0
        #: optional attached ``repro_torch.core.interference.InterferenceModel``
        #: (set by engines when interference scoring is on) so learned
        #: coefficients persist with the profiles via ``profile_store``.
        self.interference = None

    @property
    def cold_start(self) -> bool:
        return self._cold_start

    def enable_cold_start(self) -> None:
        """Switch cold-start estimation on (idempotent). Prediction values
        for PROFILED kernels are unaffected, so decision traces only change
        where the ``-1.0`` sentinel used to make a kernel invisible."""
        self._cold_start = True

    def load(self, profile: TaskProfile) -> None:
        prev = self._by_key.get(profile.key)
        if prev is not None:
            for kid, v in prev.SK.items():
                self._sk.pop((profile.key, kid), None)
                self._sk_sum -= v
                self._sk_cnt -= 1
            for kid in prev.SG:
                self._sg.pop((profile.key, kid), None)
            for kid in prev.kclass:
                self._class.pop((profile.key, kid), None)
        self._by_key[profile.key] = profile
        for kid, v in profile.SK.items():
            self._sk[(profile.key, kid)] = v
            self._sk_sum += v
            self._sk_cnt += 1
        for kid, v in profile.SG.items():
            self._sg[(profile.key, kid)] = v
        for kid, c in profile.kclass.items():
            self._class[(profile.key, kid)] = c
        if profile.SK:
            self._key_mean[profile.key] = (sum(profile.SK.values())
                                           / len(profile.SK))
        else:
            self._key_mean.pop(profile.key, None)
        self.version += 1

    def get(self, key: TaskKey) -> Optional[TaskProfile]:
        return self._by_key.get(key)

    def __contains__(self, key: TaskKey) -> bool:
        return key in self._by_key

    def keys(self):
        return self._by_key.keys()

    def predict_duration(self, key: TaskKey, kid: KernelID) -> float:
        v = self._sk.get((key, kid))
        if v is not None:
            return v
        if not self._cold_start:
            return -1.0
        return self._cold_estimate(key)

    def predict_duration_raw(self, key: TaskKey, kid: KernelID) -> float:
        """The paper's strict prediction: ``-1.0`` sentinel for anything
        unprofiled, never a cold-start estimate. The online measurement
        loop uses this to tell drift (wrong prediction) from cold
        (no prediction)."""
        return self._sk.get((key, kid), -1.0)

    def _cold_estimate(self, key: TaskKey) -> float:
        m = self._key_mean.get(key)
        if m is not None:
            self.cold_predictions += 1
            return m
        if self._sk_cnt:
            self.cold_predictions += 1
            return self._sk_sum / self._sk_cnt
        return -1.0          # nothing loaded: no estimate was served

    def predict_gap(self, key: TaskKey, kid: KernelID) -> float:
        return self._sg.get((key, kid), 0.0)

    def predict_class(self, key: TaskKey, kid: KernelID) -> str:
        """The kernel's profiled resource class; unclassified kernels
        (including every pre-classification profile) default to
        compute-bound."""
        return self._class.get((key, kid), COMPUTE_BOUND)
