"""The kernel wrappers' launch counters, and the deltas a CUDA graph
replays.

Each wrapper in ``kernels/*/ops.py`` counts its launches on attributes of
itself (``launches``, ``launches_by_shape``, ``bwd_launches``) through
``bump``, on the object its module's name is bound to when it is called.
A graph's replay runs the kernels its capture recorded without running
the wrappers, so a capture counts under ``recording``: the calling
thread's bumps go into a delta instead of the counters, and ``add`` books
that delta on every replay. The counters then read as if every call had
run eagerly, whatever other threads launch meanwhile.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Hashable, Iterator, Optional

_lock = threading.Lock()
_local = threading.local()


def _apply(owner, name: str, key: Optional[Hashable], n: int) -> None:
    if key is None:
        setattr(owner, name, getattr(owner, name) + n)
    else:
        getattr(owner, name)[key] += n


def bump(owner, name: str, n: int = 1,
         key: Optional[Hashable] = None) -> None:
    """Add ``n`` to ``owner.<name>``, or to ``owner.<name>[key]`` (a
    ``Counter``) where ``key`` is given; into the calling thread's delta
    while it records."""
    delta = getattr(_local, "delta", None)
    if delta is not None:
        delta[(owner, name, key)] += n
        return
    with _lock:
        _apply(owner, name, key, n)


@contextlib.contextmanager
def recording() -> Iterator[collections.Counter]:
    """The calling thread's bumps inside, kept out of the counters: yields
    the delta, a ``Counter`` of (owner, name, key) -> launches."""
    outer = getattr(_local, "delta", None)
    _local.delta = delta = collections.Counter()
    try:
        yield delta
    finally:
        _local.delta = outer


def add(delta: collections.Counter) -> None:
    """Book a recorded delta on the counters (once per replay)."""
    with _lock:
        for (owner, name, key), n in delta.items():
            _apply(owner, name, key, n)
