"""Online kernel measurement: live SK/SG refinement during sharing-mode
execution.

The paper's measurement phase is exclusive and expensive (Fig 15: +34.5%
to +71.8% JCT), which forces a strictly-offline two-phase design — profile
once, ``load()`` at startup, never learn again. A serving system under
shifting traffic needs the opposite (cf. Tally's non-intrusive online
measurement of concurrent DL kernels, and Strait's case for perceiving
interference live): every ``kernel_end`` the engines already observe IS a
free duration sample, and the launch-to-launch spacing of one task's
stream is a (noisy) gap sample. ``OnlineMeasurement`` turns those samples
into EMA-smoothed SK/SG updates without a measurement phase, while
staying inside FIKIT's <5% sharing-stage overhead budget (Fig 14):

- **Observation is O(1)**: a dict upsert per kernel completion, no
  timing calls of its own (the engines pass the start/end they already
  have — the sim's virtual timeline, the wall-clock device thread's
  ``perf_counter`` brackets).
- **Commits are batched in epochs** — every ``epoch_observations``
  samples or ``epoch_seconds`` seconds, whichever comes first — because
  each ``ProfiledData.version`` bump invalidates the priority queues'
  duration index and triggers a full O(n log n) rebuild on the next
  decision (``repro_torch.core.queues`` lazy binding). Per-event commits would
  put that rebuild on every completion; per-epoch commits amortize it to
  noise.
- **Per-device buffers, merged on commit**: each device's observations
  accumulate independently (the placement layer tags the device), and one
  commit folds all of them into the shared ``ProfiledData`` — one version
  bump per dirty TaskKey per epoch, regardless of device count.
- **Cold start**: ``ProfiledData(cold_start=True)`` serves provisional
  durations for never-profiled kernels (per-TaskKey mean SK, then the
  global mean) instead of the ``-1.0`` sentinel, so a cold task is
  gap-fillable immediately and its real profile converges online.
- **Drift counters**: every observation with a strict (non-cold)
  prediction accrues observed-vs-predicted error, surfaced via
  ``stats()`` into ``SimReport.online_stats`` and the serving stats — the
  signal that a loaded profile has gone stale.
- **Interference coefficients** (optional, an attached
  ``repro_torch.core.interference.InterferenceModel``): the policy tags every
  interference-scored fill launch with its (holder, filler) class pair
  (``note_fill_pair``); when the filler's completion is observed, the
  observed/predicted duration ratio becomes a slowdown sample for that
  pair, EMA-committed into the model in the SAME epochs as SK/SG, and
  the duration sample itself is DE-RATED by the pair's current
  coefficient before entering the SK buffers (so contended fills don't
  inflate the uncontended SK estimate).

The standing contract: with online measurement OFF (``online=None`` /
``OnlineConfig(enabled=False)``) nothing in this module runs and decision
traces are bit-identical to the pre-online implementation — pinned by the
randomized differential suites. With it ON, scheduling decisions may
differ (that is the point), but every safety invariant (fill below
holder, stream order, conservation) still holds — pinned by the
hypothesis suites.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.kernel_id import KernelID
from repro_torch.core.profiler import ProfiledData, TaskProfile
from repro_torch.core.task import TaskKey


@dataclass
class OnlineConfig:
    """Tuning for the online measurement loop.

    ``ema_alpha`` weights the newest epoch's batch mean against the
    standing SK/SG value (1.0 = always trust the latest epoch, small =
    long memory). ``epoch_observations``/``epoch_seconds`` bound how stale
    the committed profile may get — an epoch commits when EITHER
    threshold is crossed. ``cold_start`` switches the bound
    ``ProfiledData`` to provisional predictions for unprofiled kernels.
    ``enabled=False`` constructs the subsystem but never observes or
    commits — the wired-but-off configuration the differential suite pins
    bit-identical to no subsystem at all."""
    enabled: bool = True
    ema_alpha: float = 0.25
    epoch_observations: int = 64
    epoch_seconds: float = 1.0
    cold_start: bool = True

    @staticmethod
    def coerce(spec) -> Optional["OnlineConfig"]:
        """Normalize the engines' ``online=`` argument: None/False -> None
        (subsystem not built), True -> defaults, a config -> itself."""
        if spec is None or spec is False:
            return None
        if spec is True:
            return OnlineConfig()
        if isinstance(spec, OnlineConfig):
            return spec
        raise TypeError(f"online= expects None/bool/OnlineConfig, "
                        f"got {spec!r}")


class _DeviceBuffer:
    """One device's pending (uncommitted) observations."""

    __slots__ = ("dur", "gap", "observations")

    def __init__(self):
        # (TaskKey, KernelID) -> [sum, count]
        self.dur: Dict[Tuple[TaskKey, KernelID], List[float]] = {}
        self.gap: Dict[Tuple[TaskKey, KernelID], List[float]] = {}
        self.observations = 0

    def add_dur(self, key, kid, v: float) -> None:
        s = self.dur.get((key, kid))
        if s is None:
            self.dur[(key, kid)] = [v, 1]
        else:
            s[0] += v
            s[1] += 1
        self.observations += 1

    def add_gap(self, key, kid, v: float) -> None:
        s = self.gap.get((key, kid))
        if s is None:
            self.gap[(key, kid)] = [v, 1]
        else:
            s[0] += v
            s[1] += 1


class OnlineMeasurement:
    """Observes sharing-mode kernel completions; commits EMA-smoothed
    SK/SG updates into a ``ProfiledData`` in epochs.

    Drivers call:

    - ``observe(device, instance, key, kid, start, end, last=...)`` on
      every kernel completion (the placement layer does this for both
      engines);
    - ``observe_gap_error(predicted, actual)`` when the policy opens a
      gap with a known actual (the sim's feedback path) — pure drift
      accounting, no profile update;
    - ``task_gone(instance)`` when a task retires (drops the
      gap-attribution anchor);
    - ``commit()`` to force the pending epoch out (engines flush on
      shutdown so short runs still learn).

    Thread safety follows the engines': the wall-clock engine calls every
    entry point under its policy lock; the simulator is single-threaded.
    """

    def __init__(self, profiled: ProfiledData,
                 config: Optional[OnlineConfig] = None,
                 clock: Callable[[], float] = lambda: 0.0,
                 interference=None):
        self.profiled = profiled
        self.config = config or OnlineConfig()
        self._clock = clock
        self.interference = (interference if interference is not None
                             and getattr(interference, "enabled", False)
                             else None)
        if self.config.cold_start and self.config.enabled:
            profiled.enable_cold_start()
        self._buffers: Dict[int, _DeviceBuffer] = {}
        # instance -> (device, key, kid, end) of its last observed kernel,
        # anchoring the launch-to-launch gap sample for THAT kid
        self._last: Dict[int, Tuple[int, TaskKey, KernelID, float]] = {}
        # (instance, kid) -> FIFO of (holder_class, filler_class) tags for
        # in-flight interference-scored fills awaiting their completion
        self._pending_pairs: Dict[Tuple[int, KernelID], List] = {}
        # (holder_class, filler_class) -> [ratio_sum, count] this epoch
        self._pair_pending: Dict[Tuple[str, str], List[float]] = {}
        self._epoch_obs = 0
        self._last_commit: Optional[float] = None
        # counters (monotonic, surfaced via stats())
        self.observations = 0
        self.gap_observations = 0
        self.commits = 0
        self.committed_keys = 0
        self.cold_observations = 0
        self.drift_obs = 0
        self.drift_abs_sum = 0.0
        self.drift_pred_sum = 0.0
        self.gap_drift_obs = 0
        self.gap_drift_abs_sum = 0.0
        self.interference_pair_obs = 0
        self.interference_updates = 0

    # ------------------------------------------------------------ observing
    def observe(self, device: int, instance: int, key: TaskKey,
                kid: KernelID, start: float, end: float, *,
                last: bool = False) -> bool:
        """Record one completed kernel. Returns True iff this observation
        closed an epoch (a commit happened)."""
        if not self.config.enabled:
            return False
        now = self._clock()
        if self._last_commit is None:
            self._last_commit = now
        buf = self._buffers.get(device)
        if buf is None:
            buf = self._buffers[device] = _DeviceBuffer()
        dur = max(0.0, end - start)
        # interference attribution: was this completion a fill the policy
        # scored with a class pair? (FIFO tag matching per (instance, kid);
        # with max_inflight > 1 and repeated kids a tag can land on the
        # wrong occurrence of the same kernel — accepted EMA noise, the
        # durations are statistically exchangeable)
        pair = None
        tags = self._pending_pairs.get((instance, kid))
        if tags:
            pair = tags.pop(0)
            if not tags:
                del self._pending_pairs[(instance, kid)]
        pred = self.profiled.predict_duration_raw(key, kid)
        sk_dur = dur
        if pair is not None and self.interference is not None:
            if pred > 0.0 and dur > 0.0:
                # observed slowdown sample for this class pair
                p = self._pair_pending.setdefault(pair, [0.0, 0])
                p[0] += dur / pred
                p[1] += 1
                self.interference_pair_obs += 1
            # de-rate the contended sample back to an uncontended SK
            # estimate using the model's current belief
            sk_dur = dur / max(1.0, self.interference.coeff(*pair))
        buf.add_dur(key, kid, sk_dur)
        self.observations += 1
        self._epoch_obs += 1
        # drift: compare against the STRICT prediction (no cold estimate),
        # so cold kernels count as cold, not as infinitely wrong
        if pred >= 0.0:
            self.drift_obs += 1
            self.drift_abs_sum += abs(sk_dur - pred)
            self.drift_pred_sum += pred
        else:
            self.cold_observations += 1
        # gap attribution: device idle between consecutive kernels of ONE
        # stream approximates the host gap after the PREVIOUS kernel (the
        # same bracketing measure_run uses, under sharing noise — fillers
        # occupying the gap inflate the sample; EMA + epochs smooth it).
        # A negative raw gap (overlapping brackets — wall-clock callback
        # jitter, or a stale anchor) is SKIPPED, not clamped: a fabricated
        # 0.0 sample would drag the SG estimate toward zero.
        prev = self._last.get(instance)
        if prev is not None and prev[0] == device:
            gap = start - prev[3]
            if gap >= 0.0:
                buf.add_gap(prev[1], prev[2], gap)
                self.gap_observations += 1
        if last:
            self._last.pop(instance, None)
        else:
            self._last[instance] = (device, key, kid, end)
        if (self._epoch_obs >= self.config.epoch_observations
                or now - self._last_commit >= self.config.epoch_seconds):
            self.commit(now)
            return True
        return False

    def observe_gap_error(self, predicted: float, actual: float) -> None:
        """Drift accounting for the policy's SG predictions (paper Fig 12
        feedback path): no profile update, just observed-vs-predicted."""
        if not self.config.enabled:
            return
        self.gap_drift_obs += 1
        self.gap_drift_abs_sum += abs(actual - predicted)

    def note_fill_pair(self, instance: int, kid: KernelID,
                       holder_class: str, filler_class: str) -> None:
        """Tag an interference-scored fill launch with its class pair so
        the eventual completion's duration can be attributed (called by
        the policy at fill-launch time)."""
        if not self.config.enabled:
            return
        self._pending_pairs.setdefault((instance, kid), []).append(
            (holder_class, filler_class))

    def task_gone(self, instance: int) -> None:
        """Drop the gap anchor — and any in-flight fill tags — of a
        retired/migrated task. The placement layer calls this BEFORE a
        steal detaches the task, so a cross-device launch can never be
        attributed against the old device's timeline."""
        self._last.pop(instance, None)
        if self._pending_pairs:
            stale = [k for k in self._pending_pairs if k[0] == instance]
            for k in stale:
                del self._pending_pairs[k]

    # ------------------------------------------------------------ committing
    def commit(self, now: Optional[float] = None) -> int:
        """Fold every device's pending observations into the shared
        ``ProfiledData`` (one ``load()`` — one version bump — per dirty
        TaskKey). Returns the number of TaskKeys updated."""
        if not self.config.enabled:
            return 0
        alpha = self.config.ema_alpha
        merged_dur: Dict[Tuple[TaskKey, KernelID], List[float]] = {}
        merged_gap: Dict[Tuple[TaskKey, KernelID], List[float]] = {}
        for buf in self._buffers.values():
            for k, (s, c) in buf.dur.items():
                m = merged_dur.setdefault(k, [0.0, 0])
                m[0] += s
                m[1] += c
            for k, (s, c) in buf.gap.items():
                m = merged_gap.setdefault(k, [0.0, 0])
                m[0] += s
                m[1] += c
        self._buffers.clear()
        self._epoch_obs = 0
        self._last_commit = self._clock() if now is None else now
        if not merged_dur and not merged_gap:
            return 0

        dirty: Dict[TaskKey, TaskProfile] = {}

        def live(key: TaskKey) -> TaskProfile:
            prof = dirty.get(key)
            if prof is None:
                cur = self.profiled.get(key)
                prof = cur.clone() if cur is not None \
                    else TaskProfile(key=key)
                prof.ema_alpha = alpha
                dirty[key] = prof
            return prof

        for (key, kid), (s, c) in merged_dur.items():
            prof = live(key)
            batch = s / c
            old = prof.SK.get(kid)
            prof.SK[kid] = batch if old is None \
                else (1.0 - alpha) * old + alpha * batch
            prof.obs_count[kid] = prof.obs_count.get(kid, 0) + c
        for (key, kid), (s, c) in merged_gap.items():
            prof = live(key)
            batch = s / c
            old = prof.SG.get(kid)
            prof.SG[kid] = batch if old is None \
                else (1.0 - alpha) * old + alpha * batch
            prof.gap_obs_count[kid] = prof.gap_obs_count.get(kid, 0) + c
        for prof in dirty.values():
            self.profiled.load(prof)
        self.commits += 1
        self.committed_keys += len(dirty)
        # interference coefficients commit in the SAME epochs as SK/SG:
        # one EMA fold per class pair from this epoch's batch-mean ratio
        if self.interference is not None and self._pair_pending:
            for pair, (s, c) in self._pair_pending.items():
                self.interference.update(pair, s / c, alpha)
                self.interference_updates += 1
            self._pair_pending.clear()
        return len(dirty)

    # ---------------------------------------------------------------- stats
    @property
    def pending_observations(self) -> int:
        return sum(b.observations for b in self._buffers.values())

    def stats(self) -> Dict[str, float]:
        """Counters for ``SimReport.online_stats`` / serving stats."""
        return {
            "observations": self.observations,
            "gap_observations": self.gap_observations,
            "commits": self.commits,
            "committed_keys": self.committed_keys,
            "pending_observations": self.pending_observations,
            "cold_observations": self.cold_observations,
            "cold_predictions": self.profiled.cold_predictions,
            "drift_obs": self.drift_obs,
            "drift_mean_abs_err": (self.drift_abs_sum / self.drift_obs
                                   if self.drift_obs else 0.0),
            "drift_mean_rel_err": (self.drift_abs_sum / self.drift_pred_sum
                                   if self.drift_pred_sum > 0.0 else 0.0),
            "gap_drift_obs": self.gap_drift_obs,
            "gap_drift_mean_abs_err": (
                self.gap_drift_abs_sum / self.gap_drift_obs
                if self.gap_drift_obs else 0.0),
            "interference_pair_obs": self.interference_pair_obs,
            "interference_updates": self.interference_updates,
        }
