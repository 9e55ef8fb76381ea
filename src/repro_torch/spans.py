"""The port's span recorder: one row per kernel request that an engine's
device thread ran, kept in a ring of fixed size.

It is always on, like a flight recorder a serving node can be read from
after an incident: there is no switch, and a row costs a tuple and a
few clock reads a segment. ``WallClockEngine._device_loop`` stamps and
appends the rows; a segment body calls ``mark_issued`` when it has
issued its last kernel and is about to wait for the card.

Every stamp is ``time.perf_counter()`` seconds: the engine's clock, the
clock of ``KernelRequest.submit_time``, and the one a device trace is put
on, so rows line up with device activity as they are. A row's stamps, in
the order they are taken:

    submit  the request entered the engine (``WallClockEngine.submit``)
    asked   the device thread began to wait on its queue for it
    got     the queue handed it over
    start   its payload began
    issued  its segment issued its last kernel (``end`` where the payload
            never called ``mark_issued``)
    end     its payload returned
    booked  the engine's bookkeeping under its lock was done
    done    its completion callback returned: the client's host work and
            the submit of its next segment

``submit`` may fall after ``asked``: the thread may wait on an empty
queue before the request exists.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import List, NamedTuple, Optional

#: rows the ring holds: the busiest benchmark cell (F.fill) runs about 500
#: segments a second on an H100's host, some 25,000 in its 50 s window and
#: lead-in, so the ring holds such a window five times over
CAPACITY = 1 << 17


class Row(NamedTuple):
    device: int
    instance: int       # the request's task instance, shared by its segments
    seq: int            # the segment's index within the task
    priority: int
    filler: bool        # placed into a higher-priority task's gap
    kernel: str         # the KernelID's name
    submit: float
    asked: float
    got: float
    start: float
    issued: float
    end: float
    booked: float
    done: float


_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_written = 0                    # rows appended since the last clear()
_lock = threading.Lock()
_issued = threading.local()


def record(row: tuple) -> None:
    """Append ``row``, a plain tuple of ``Row``'s fields (read back as a
    ``Row``), overwriting the oldest once the ring is full."""
    global _written
    with _lock:
        _ring.append(row)
        _written += 1


def rows(since: Optional[float] = None) -> List[Row]:
    """A copy of the rows held, oldest first (in the order they were
    recorded); with ``since``, those whose ``start`` is not before it."""
    with _lock:
        out = list(_ring)
    out = [Row._make(r) for r in out]
    if since is not None:
        out = [r for r in out if r.start >= since]
    return out


def dropped() -> int:
    """Rows overwritten since the last ``clear()``."""
    with _lock:
        return _written - len(_ring)


def clear() -> None:
    global _written
    with _lock:
        _ring.clear()
        _written = 0


def mark_issued() -> None:
    """Stamp, for the calling thread, the moment a segment issued its last
    kernel."""
    _issued.t = time.perf_counter()


def take_issued(default: float) -> float:
    """The calling thread's ``mark_issued`` stamp since the last call, or
    ``default``; the slot is emptied."""
    t = getattr(_issued, "t", None)
    _issued.t = None
    return default if t is None else t
