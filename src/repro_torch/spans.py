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

Beside the ring, ``count_graph`` counts the segments' CUDA graphs
(``models.graphs``) since the process started: ``captured`` graphs,
segment calls ``replayed`` from one, and CUDA segment calls run ``eager``
(the call that captures a graph). ``clear`` leaves these counts.

``count_moe`` keeps, per MoE layer module of each service, device-side
accumulators of the entries routed to each expert and of those dropped
past capacity, updated by in-place adds on the layer's own stream (inside
a captured layer's graph too), with no sync; ``moe_counts`` reads them
back, once, after the window. ``clear`` leaves these too.
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


class MoECount(NamedTuple):
    """What one MoE layer module routed since its first served forward."""
    model: str          # the model's config name
    layer: str          # the module's parameter prefix, ``layers.<i>.moe``
    routed: List[int]   # entries routed to each expert, before capacity
    dropped: int        # entries dropped past an expert's capacity


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


#: what ``count_graph`` counts
GRAPH_EVENTS = ("captured", "replayed", "eager")

_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_written = 0                    # rows appended since the last clear()
_graph_events = dict.fromkeys(GRAPH_EVENTS, 0)
_moe: list = []                 # (model, layer, accumulator) per module
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


def count_graph(event: str) -> None:
    """Count one of ``GRAPH_EVENTS``."""
    with _lock:
        _graph_events[event] += 1


def graph_counts() -> dict:
    """Each of ``GRAPH_EVENTS`` counted since the process started."""
    with _lock:
        return dict(_graph_events)


def count_moe(owner, name: tuple, counts, dropped) -> None:
    """Add ``counts`` (a device tensor of entries routed to each expert)
    and ``dropped`` (a device scalar) to the accumulator of ``owner``, the
    layer's module, named ``name`` (model, layer): one int64 tensor of
    len(counts) + 1 on their device, made on the module's first count
    there (outside any capture, since a captured segment runs eagerly
    first; a normal tensor, not an inference one, so that forwards under
    ``inference_mode`` and outside it both add to it)."""
    acc = getattr(owner, "_moe_counts", None)
    if acc is None or acc.device != counts.device:
        import torch            # not at import: the store-only verbs
        with torch.inference_mode(False):   # updated in and outside it
            acc = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                              device=counts.device)
        owner._moe_counts = acc
        with _lock:
            _moe.append((*name, acc))
    acc[:-1].add_(counts)
    acc[-1:].add_(dropped.reshape(1))


def moe_counts() -> List[MoECount]:
    """Every MoE layer module's counts (a device sync)."""
    with _lock:
        held = list(_moe)
    out = []
    for model, layer, acc in held:
        values = acc.tolist()
        out.append(MoECount(model, layer, values[:-1], values[-1]))
    return out
