"""Priority queues Q0..Q9 (paper Fig 7) with per-level queue disciplines.

The scheduler scans queues from highest (Q0) to lowest (Q9). WITHIN a
level, ordering is a pluggable *queue discipline* (``QUEUE_DISCIPLINES``):

- ``fifo`` (default) — the paper's behavior, pinned bit-identical to the
  pre-discipline implementation: pops release the oldest-parked request,
  and gap filling (``best_fit_under``) selects the LONGEST fitting stream
  head, ties resolved to the earliest-parked one.
- ``sjf``  — shortest-job-first (cf. Strait's interference-aware ordering):
  pops release the stream head with the SHORTEST predicted SK duration
  (unprofiled heads carry the -1.0 sentinel and sort shortest), and gap
  filling selects the shortest profiled head that fits the idle gap — a
  successor search over the same duration index the FIFO predecessor
  search uses. Ties resolve to the earliest-parked head. Without a bound
  profile there are no predictions, and ``sjf`` degrades to FIFO order
  deterministically.
- ``edf``  — earliest-deadline-first (cf. RTGPU-style deadline-driven
  scheduling): requests carry an optional absolute ``deadline``; pops
  release the earliest-deadline stream head, and gap filling keeps the
  paper's primary criterion (longest fit — gap utilization is still the
  point) but resolves predicted-duration TIES to the earliest deadline
  instead of the earliest-parked request. A request without a deadline
  sorts after every dated request and falls back to FIFO order among
  undated peers — an all-undated ``edf`` level is behaviorally identical
  to a ``fifo`` level.

Disciplines are fixed per level at construction
(``discipline_by_level=``: one name for all levels, a ``{level: name}``
mapping, or a full per-level sequence). Unknown names raise ``ValueError``
naming ``sorted(QUEUE_DISCIPLINES)``. Bulk release on holder retirement
intentionally stays in park (FIFO) order regardless of discipline: a
release launches EVERY affected request onto the serial device queue, and
park order is the one ordering that is provably stream-safe.

Indexed representation
----------------------
The paper's <5% overhead budget means each scheduling decision must cost
far less than a 0.1-2 ms kernel launch, at production queue depths. The
naive structure (one deque per level, linear scans everywhere) makes
``best_prio_fit`` O(total queued) per fill decision. Each level therefore
maintains coupled views:

- ``fifo``     — OrderedDict uid -> request: park order; O(1) push, O(1)
  remove-by-request, O(1) oldest (``pop_highest``/``peek_highest``).
- ``streams``  — (task_key, instance) -> deque of that stream's parked
  requests in seq order. Only the *head* of a stream is eligible for gap
  filling (a CUDA stream's kernels must reach the device in issue order),
  so the fill decision only ever looks at one request per stream.
- ``index``    — bisect-sorted list over the level's stream heads, keyed
  by predicted duration. FIFO/SJF levels store ``(predicted_duration,
  -push_seq, uid)``: "longest head under the idle gap" is a predecessor
  search, "shortest profiled head under the gap" a successor search —
  both O(log n), and ties on duration resolve to the earliest-parked head
  either way. EDF levels store ``(predicted_duration, deadline, push_seq,
  uid)`` so the longest-fit predecessor search can resolve duration ties
  to the earliest deadline with one extra bisect to the run start.
- ``dindex``   — EDF levels only: bisect-sorted ``(deadline, push_seq,
  uid)`` over stream heads (undated requests carry ``inf``), driving
  earliest-deadline-first pops in O(log n). Maintained independently of
  the profile binding — deadlines need no predictions.

Predicted durations come from a bound ``ProfiledData``; the binding is
lazy (first indexed decision) and keyed on ``ProfiledData.version`` so a
profile (re)load invalidates cached durations and triggers one O(n log n)
rebuild instead of serving stale predictions. This is also the seam the
ONLINE measurement loop (``repro_torch.core.online``) rides: an epoch commit
bumps ``version`` once per dirty TaskKey, and the next decision rebuilds
against the refreshed SK values — which is exactly why online updates are
batched in epochs rather than committed per kernel completion. The
binding is additionally keyed on the profile's ``cold_start`` flag:
flipping ``enable_cold_start()`` mid-run does not bump ``version`` (cold
estimates are pure functions of already-loaded state), but it changes
what ``predict_duration`` returns for unprofiled heads, so an index built
before the flip would serve stale ``-1.0`` sentinels while the O(n)
reference scan serves fresh estimates within the same decision.

Interference-aware filling (``interference=`` an enabled
``repro_torch.core.interference.InterferenceModel``) additionally partitions
each level's duration index by the head's resource class (``cindex``:
class -> bisect-sorted entries, same tuples as ``index``). A fill
decision with a known holder class then runs the same predecessor /
successor searches once per class against a per-class limit
``idle_time / coeff(holder_class, class)`` — a candidate fits only if its
predicted duration times the pair's slowdown coefficient still fits the
gap. With no model (the pinned default) or no holder class the plain
single-index search runs unchanged, bit-identical to the
pre-interference implementation.

A request's priority must be fixed while parked (it is: priority is a
property of the owning task), so a stream never spans levels and
per-level stream heads are exactly the global stream heads.

``reference=True`` switches ``pop_highest``/``peek_highest`` to an O(n)
scan over the stream heads that recomputes every discipline key from
scratch — the oracle the differential tests pin the indexed pops against
(the fill-side oracle is ``repro_torch.core.fikit.best_prio_fit_scan``).

``threadsafe=False`` elides the RLock (a no-op context manager) for
single-threaded drivers like the discrete-event simulator; the threaded
wall-clock engine keeps the real lock.
"""
from __future__ import annotations

import itertools
import math
import threading
from bisect import bisect_left, insort
from collections import OrderedDict, deque
from collections.abc import Mapping
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

from repro_torch.core.task import NUM_PRIORITIES, KernelRequest

#: sentinel: ``ProfiledData.predict_duration`` returns -1.0 for unprofiled
#: kernels; the reference scan's ``best > -1.0`` guard excludes exactly
#: those, and the indexed predecessor search must agree.
_UNPROFILED = -1.0

#: The queue-discipline registry. To add a discipline: append its name
#: here, implement the indexed selection in ``best_fit_under`` and
#: ``_pop_choice``, the O(n) oracles in ``_pop_choice_scan`` and
#: ``repro_torch.core.fikit.best_prio_fit_scan``, and extend the randomized
#: differential suite in ``tests/test_policy_differential.py`` (the
#: ROADMAP's rule for touching decision logic).
QUEUE_DISCIPLINES: Tuple[str, ...] = ("fifo", "sjf", "edf")

#: Accepted ``discipline_by_level`` / ``FikitPolicy(discipline=...)`` spec:
#: a single name for all levels, a ``{level: name}`` mapping (unnamed
#: levels default to ``fifo``), or a full per-level sequence.
QueueDisciplineSpec = Union[None, str, Mapping, Sequence]


def _check_discipline(name) -> str:
    if name not in QUEUE_DISCIPLINES:
        raise ValueError(f"unknown queue discipline: {name!r} "
                         f"(known: {sorted(QUEUE_DISCIPLINES)})")
    return name


def normalize_disciplines(spec: QueueDisciplineSpec,
                          levels: int) -> Tuple[str, ...]:
    """Resolve a discipline spec to one name per level, validating names.

    ``None`` or ``"fifo"`` -> all-FIFO; a single name applies to every
    level; a mapping names specific levels (others FIFO); a sequence must
    name all ``levels`` levels. Unknown names or out-of-range levels raise
    ``ValueError``."""
    if spec is None:
        return ("fifo",) * levels
    if isinstance(spec, str):
        return (_check_discipline(spec),) * levels
    if isinstance(spec, Mapping):
        for lvl, name in spec.items():
            if not (isinstance(lvl, int) and 0 <= lvl < levels):
                raise ValueError(
                    f"discipline level {lvl!r} out of range [0, {levels})")
            _check_discipline(name)
        return tuple(spec.get(p, "fifo") for p in range(levels))
    names = tuple(spec)
    if len(names) != levels:
        raise ValueError(f"discipline_by_level sequence must name all "
                         f"{levels} levels, got {len(names)}")
    for name in names:
        _check_discipline(name)
    return names


def _dl(req: KernelRequest) -> float:
    """EDF sort key: undated requests sort after every dated one."""
    return req.deadline if req.deadline is not None else math.inf


class _NullLock:
    """No-op reentrant context manager for single-threaded fast paths."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_LOCK = _NullLock()


class _Level:
    """One priority level's coupled FIFO / stream / index views."""

    __slots__ = ("discipline", "fifo", "seq", "streams", "index", "indexed",
                 "dindex", "dindexed", "cindex", "cindexed")

    def __init__(self, discipline: str = "fifo"):
        self.discipline = discipline
        self.fifo: "OrderedDict[int, KernelRequest]" = OrderedDict()
        self.seq: Dict[int, int] = {}              # uid -> push sequence
        self.streams: Dict[tuple, deque] = {}      # stream -> parked reqs
        self.index: List[tuple] = []               # duration index (heads)
        self.indexed: Dict[int, tuple] = {}
        self.dindex: List[tuple] = []              # EDF deadline index
        self.dindexed: Dict[int, tuple] = {}
        self.cindex: Dict[str, List[tuple]] = {}   # class -> duration index
        self.cindexed: Dict[int, str] = {}         # uid -> resource class


def _stream_of(req: KernelRequest) -> tuple:
    return (req.task_key, req.task_instance)


class PriorityQueues:
    def __init__(self, levels: int = NUM_PRIORITIES, *,
                 profiled=None, threadsafe: bool = True,
                 discipline_by_level: QueueDisciplineSpec = None,
                 reference: bool = False, interference=None):
        self.levels = levels
        self._disciplines = normalize_disciplines(discipline_by_level,
                                                  levels)
        self._levels: List[_Level] = [_Level(d) for d in self._disciplines]
        self._any_nonfifo = any(d != "fifo" for d in self._disciplines)
        self._reference = reference
        self._size = 0
        self._lock = threading.RLock() if threadsafe else _NULL_LOCK
        self._push_seq = itertools.count()
        self._profiled = profiled
        self._version = profiled.version if profiled is not None else -1
        self._cold = profiled.cold_start if profiled is not None else False
        self._interference = interference
        self._iron = (interference is not None
                      and getattr(interference, "enabled", False))

    def discipline_of(self, priority: int) -> str:
        """The queue discipline governing level ``priority``."""
        return self._disciplines[priority]

    @property
    def bound_version(self) -> int:
        """The ``ProfiledData.version`` the duration index was last built
        against (-1: never bound). A mismatch with the live profile's
        ``version`` means the next indexed decision pays one O(n log n)
        rebuild — the invalidation contract the online measurement tests
        pin."""
        return self._version

    # -------------------------------------------------------------- mutation
    def push(self, req: KernelRequest) -> None:
        with self._lock:
            lvl = self._levels[req.priority]
            seq = next(self._push_seq)
            lvl.fifo[req.uid] = req
            lvl.seq[req.uid] = seq
            stream = _stream_of(req)
            dq = lvl.streams.get(stream)
            if dq is None:
                dq = lvl.streams[stream] = deque()
            dq.append(req)
            if len(dq) == 1:
                if self._profiled is not None:
                    self._index_head(lvl, req, seq)
                if lvl.discipline == "edf":
                    self._dindex_head(lvl, req, seq)
            self._size += 1

    def remove(self, req: KernelRequest) -> None:
        with self._lock:
            self._remove(req)

    def pop_highest(self) -> Optional[KernelRequest]:
        """Pop one request from the highest-priority non-empty queue,
        selected by that level's discipline (FIFO: oldest; SJF: shortest
        predicted head; EDF: earliest-deadline head). Only stream HEADS are
        popped, so a pop can never reorder a stream. O(1) for FIFO levels,
        O(log n) for SJF/EDF."""
        with self._lock:
            if self._any_nonfifo and self._profiled is not None:
                self.ensure_index(self._profiled)
            for lvl in self._levels:
                if lvl.fifo:
                    req = self._pop_choice(lvl)
                    self._remove(req)
                    return req
        return None

    def _pop_choice(self, lvl: _Level) -> KernelRequest:
        """Select (without removing) the request a pop should release from
        ``lvl`` under its discipline."""
        if self._reference:
            return self._pop_choice_scan(lvl)
        disc = lvl.discipline
        if disc == "sjf" and lvl.index:
            # successor run of the minimal duration; earliest-parked tie.
            # (-seq <= 0 < 1, so (dur, 1) upper-bounds the dur run.)
            d0 = lvl.index[0][0]
            k = bisect_left(lvl.index, (d0, 1))
            return lvl.fifo[lvl.index[k - 1][2]]
        if disc == "edf" and lvl.dindex:
            return lvl.fifo[lvl.dindex[0][2]]
        # FIFO level — or a discipline level with no index to serve it
        # (no bound profile): degrade to FIFO order deterministically.
        return next(iter(lvl.fifo.values()))

    def _pop_choice_scan(self, lvl: _Level) -> KernelRequest:
        """O(n) reference oracle for ``_pop_choice``: recompute every
        stream head's discipline key from scratch (fresh predictions, no
        index). Pinned trace-identical to the indexed path by
        ``tests/test_policy_differential.py``."""
        disc = lvl.discipline
        best = None
        best_key = None
        for dq in lvl.streams.values():
            head = dq[0]
            seq = lvl.seq[head.uid]
            if disc == "sjf":
                dur = (self._profiled.predict_duration(head.task_key,
                                                       head.kernel_id)
                       if self._profiled is not None else _UNPROFILED)
                key = (dur, seq)
            elif disc == "edf":
                key = (_dl(head), seq)
            else:
                key = (seq,)
            if best is None or key < best_key:
                best, best_key = head, key
        return best

    def _remove(self, req: KernelRequest) -> None:
        lvl = self._levels[req.priority]
        if req.uid not in lvl.fifo:
            raise ValueError(f"{req!r} not queued")
        del lvl.fifo[req.uid]
        del lvl.seq[req.uid]
        stream = _stream_of(req)
        dq = lvl.streams[stream]
        if dq[0] is req:
            dq.popleft()
            self._unindex(lvl, req)
            if dq:                      # successor becomes the stream head
                head = dq[0]
                if self._profiled is not None:
                    self._index_head(lvl, head, lvl.seq[head.uid])
                if lvl.discipline == "edf":
                    self._dindex_head(lvl, head, lvl.seq[head.uid])
            else:
                del lvl.streams[stream]
        else:                           # mid-stream removal: rare, O(stream)
            dq.remove(req)
        self._size -= 1

    # -------------------------------------------------------- head indexes
    def _index_head(self, lvl: _Level, req: KernelRequest, seq: int) -> None:
        dur = self._profiled.predict_duration(req.task_key, req.kernel_id)
        if lvl.discipline == "edf":
            entry = (dur, _dl(req), seq, req.uid)
        else:
            entry = (dur, -seq, req.uid)
        insort(lvl.index, entry)
        lvl.indexed[req.uid] = entry
        if self._iron:
            cls = self._profiled.predict_class(req.task_key, req.kernel_id)
            cidx = lvl.cindex.get(cls)
            if cidx is None:
                cidx = lvl.cindex[cls] = []
            insort(cidx, entry)
            lvl.cindexed[req.uid] = cls

    def _dindex_head(self, lvl: _Level, req: KernelRequest,
                     seq: int) -> None:
        dentry = (_dl(req), seq, req.uid)
        insort(lvl.dindex, dentry)
        lvl.dindexed[req.uid] = dentry

    def _unindex(self, lvl: _Level, req: KernelRequest) -> None:
        entry = lvl.indexed.pop(req.uid, None)
        if entry is not None:
            i = bisect_left(lvl.index, entry)
            # entry uids are unique, so the slot is exact
            del lvl.index[i]
            cls = lvl.cindexed.pop(req.uid, None)
            if cls is not None:
                cidx = lvl.cindex[cls]
                del cidx[bisect_left(cidx, entry)]
        dentry = lvl.dindexed.pop(req.uid, None)
        if dentry is not None:
            del lvl.dindex[bisect_left(lvl.dindex, dentry)]

    def ensure_index(self, profiled) -> None:
        """Bind/refresh the head indexes against ``profiled``.

        O(1) when already bound to this profile version; a full O(n log n)
        rebuild when the profile object, its version, or its ``cold_start``
        flag changed (profiles reload rarely; decisions happen constantly).
        The cold flag is part of the binding key because flipping
        ``enable_cold_start()`` changes unprofiled heads' predictions
        without bumping ``version`` — an index built before the flip would
        disagree with the fresh-prediction reference scan."""
        if (profiled is self._profiled and self._version == profiled.version
                and self._cold == profiled.cold_start):
            return
        with self._lock:
            self._profiled = profiled
            self._version = profiled.version
            self._cold = profiled.cold_start
            for lvl in self._levels:
                entries = []
                dentries = []
                centries: Dict[str, List[tuple]] = {}
                for dq in lvl.streams.values():
                    head = dq[0]
                    seq = lvl.seq[head.uid]
                    dur = profiled.predict_duration(head.task_key,
                                                    head.kernel_id)
                    if lvl.discipline == "edf":
                        entry = (dur, _dl(head), seq, head.uid)
                        dentries.append((_dl(head), seq, head.uid))
                    else:
                        entry = (dur, -seq, head.uid)
                    entries.append(entry)
                    if self._iron:
                        cls = profiled.predict_class(head.task_key,
                                                     head.kernel_id)
                        centries.setdefault(cls, []).append(entry)
                entries.sort()
                lvl.index = entries
                lvl.indexed = {e[-1]: e for e in entries}
                if lvl.discipline == "edf":
                    dentries.sort()
                    lvl.dindex = dentries
                    lvl.dindexed = {e[-1]: e for e in dentries}
                if self._iron:
                    for cidx in centries.values():
                        cidx.sort()
                    lvl.cindex = centries
                    lvl.cindexed = {e[-1]: c
                                    for c, cidx in centries.items()
                                    for e in cidx}

    def best_fit_under(self, idle_time: float, holder_class: str = None
                       ) -> Tuple[Optional[KernelRequest], float]:
        """Gap-fill selection across levels, per-level discipline-aware.

        FIFO levels replicate the paper's Algorithm 2 bit-for-bit: the
        longest stream head with predicted duration strictly inside
        (best_so_far, idle_time); starting the running best at -1.0
        excludes unprofiled heads (the -1.0 sentinel), and descending past
        a level whose best fit is non-positive replicates the reference
        scan's ``if best_kernel_time > 0: break`` stop rule. SJF levels
        instead select the SHORTEST profiled fitting head (successor
        search); EDF levels keep the longest-fit criterion but break
        duration ties to the earliest deadline. An SJF/EDF level that holds
        any profiled fitting head claims the decision (search stops there);
        its candidate replaces a carried best only if strictly longer — the
        same strictly-better rule FIFO levels apply.

        With a bound enabled interference model AND a ``holder_class``,
        the same searches run per resource class against a tightened
        per-class limit ``idle_time / coeff(holder_class, class)`` — see
        ``_best_fit_interference``. Without either, the plain single-index
        search below runs unchanged.

        At most a few bisects per level; at most ``levels`` levels. Does
        NOT dequeue. Call ``ensure_index`` first. The O(n) oracle with
        identical semantics is ``repro_torch.core.fikit.best_prio_fit_scan``."""
        if holder_class is not None and self._iron:
            return self._best_fit_interference(idle_time, holder_class)
        best_req: Optional[KernelRequest] = None
        best_dur = _UNPROFILED
        for lvl in self._levels:
            idx = lvl.index
            if not idx:
                continue
            disc = lvl.discipline
            if disc == "fifo":
                i = bisect_left(idx, (idle_time,))
                if i == 0:
                    continue                # every head >= idle_time
                dur, _negseq, uid = idx[i - 1]
                if dur <= best_dur:
                    continue                # not strictly longer
                best_req, best_dur = lvl.fifo[uid], dur
                if best_dur > 0:
                    break                   # fit found at this level
            elif disc == "sjf":
                # successor search: shortest PROFILED head under the gap.
                # (-seq <= 0 < 1 bounds the unprofiled sentinel run.)
                j = bisect_left(idx, (_UNPROFILED, 1))
                if j == len(idx):
                    continue                # no profiled heads
                dur = idx[j][0]
                if dur >= idle_time:
                    continue                # shortest profiled doesn't fit
                if dur > best_dur:
                    k = bisect_left(idx, (dur, 1))   # earliest-parked tie
                    best_req, best_dur = lvl.fifo[idx[k - 1][2]], dur
                break                       # this level claims the decision
            else:  # edf
                i = bisect_left(idx, (idle_time,))
                if i == 0:
                    continue
                dur = idx[i - 1][0]
                if dur <= _UNPROFILED:
                    continue                # only unprofiled heads fit
                if dur > best_dur:
                    lo = bisect_left(idx, (dur,))    # earliest-deadline tie
                    best_req, best_dur = lvl.fifo[idx[lo][3]], dur
                break                       # this level claims the decision
        return best_req, best_dur

    def _best_fit_interference(self, idle_time: float, holder_class: str
                               ) -> Tuple[Optional[KernelRequest], float]:
        """Interference-aware ``best_fit_under``: the per-level search runs
        once per resource class over ``cindex`` with a per-class limit
        ``idle_time / coeff(holder_class, class)``, then merges the
        per-class candidates under the SAME selection/tie rules the plain
        search applies (FIFO/EDF: longest raw duration; SJF: shortest;
        ties to earliest-parked, EDF duration ties to earliest deadline).
        Returned durations stay RAW predicted durations — the caller debits
        the gap by the coefficient-scaled effective duration. Both sides of
        the fit comparison use ``dur < limit`` (never ``dur * coeff <
        idle_time``) so the O(n) scan oracle computes bit-identical
        float comparisons."""
        model = self._interference
        best_req: Optional[KernelRequest] = None
        best_dur = _UNPROFILED
        for lvl in self._levels:
            disc = lvl.discipline
            if disc == "fifo":
                cand = None          # best (dur, -seq, uid) across classes
                for cls, cidx in lvl.cindex.items():
                    if not cidx:
                        continue
                    limit = idle_time / model.coeff(holder_class, cls)
                    i = bisect_left(cidx, (limit,))
                    if i == 0:
                        continue            # every head of cls >= limit
                    e = cidx[i - 1]
                    if cand is None or e > cand:
                        cand = e            # longest; tie: earliest-parked
                if cand is None:
                    continue
                dur = cand[0]
                if dur <= best_dur:
                    continue                # unprofiled, or not longer
                best_req, best_dur = lvl.fifo[cand[2]], dur
                if best_dur > 0:
                    break                   # fit found at this level
            elif disc == "sjf":
                cand = None                 # min (dur, seq, uid)
                for cls, cidx in lvl.cindex.items():
                    if not cidx:
                        continue
                    limit = idle_time / model.coeff(holder_class, cls)
                    j = bisect_left(cidx, (_UNPROFILED, 1))
                    if j == len(cidx):
                        continue            # no profiled heads of cls
                    dur = cidx[j][0]
                    if dur >= limit:
                        continue            # shortest of cls doesn't fit
                    k = bisect_left(cidx, (dur, 1))  # earliest-parked tie
                    e = cidx[k - 1]
                    key = (dur, -e[1], e[2])
                    if cand is None or key < cand:
                        cand = key
                if cand is None:
                    continue
                dur = cand[0]
                if dur > best_dur:
                    best_req, best_dur = lvl.fifo[cand[2]], dur
                break                       # this level claims the decision
            else:  # edf
                cand = None                 # min (-dur, deadline, seq)
                cand_uid = None
                for cls, cidx in lvl.cindex.items():
                    if not cidx:
                        continue
                    limit = idle_time / model.coeff(holder_class, cls)
                    i = bisect_left(cidx, (limit,))
                    if i == 0:
                        continue
                    dur = cidx[i - 1][0]
                    if dur <= _UNPROFILED:
                        continue            # only unprofiled heads fit
                    lo = bisect_left(cidx, (dur,))   # earliest-deadline tie
                    e = cidx[lo]
                    key = (-e[0], e[1], e[2])
                    if cand is None or key < cand:
                        cand, cand_uid = key, e[3]
                if cand is None:
                    continue
                dur = -cand[0]
                if dur > best_dur:
                    best_req, best_dur = lvl.fifo[cand_uid], dur
                break                       # this level claims the decision
        return best_req, best_dur

    # ------------------------------------------------------------ inspection
    def __getitem__(self, priority: int) -> Tuple[KernelRequest, ...]:
        """Level contents in FIFO order (read-only snapshot)."""
        return tuple(self._levels[priority].fifo.values())

    def peek_highest(self) -> Optional[KernelRequest]:
        """The request ``pop_highest`` would release, without removing it."""
        with self._lock:
            if self._any_nonfifo and self._profiled is not None:
                self.ensure_index(self._profiled)
            for lvl in self._levels:
                if lvl.fifo:
                    return self._pop_choice(lvl)
        return None

    def highest_nonempty(self) -> Optional[int]:
        with self._lock:
            for p, lvl in enumerate(self._levels):
                if lvl.fifo:
                    return p
        return None

    def __len__(self) -> int:
        return self._size

    def __iter__(self) -> Iterator[KernelRequest]:
        with self._lock:
            snapshot = [req for lvl in self._levels
                        for req in lvl.fifo.values()]
        return iter(snapshot)

    def lock(self):
        return self._lock
