"""The port's span recorder (``repro_torch.spans``): the engine's device
thread records one row per kernel request, its stamps in the order they
are taken, in a ring of fixed size; and a request's input is released
once it has run."""
import gc
import sys
import threading
import time
import weakref

import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.core.client import HookClient, Segment  # noqa: E402
from repro_torch.core.executor import WallClockEngine  # noqa: E402
from repro_torch.core.profiler import ProfiledData, Profiler  # noqa: E402
from repro_torch.core.scheduler import Mode  # noqa: E402
from repro_torch.core.task import TaskKey  # noqa: E402


def _row(i=0, start=0.0):
    return spans.Row(0, i, 0, 0, False, "t/layer", start, start, start,
                     start, start, start, start, start)


def _segments(name, n, dur, host_gap=0.0, issue=True):
    """Sleep-based segments; with ``issue``, each marks its last kernel
    issued halfway, as a segment body ending in a device sync does."""
    def fn(state):
        time.sleep(dur / 2)
        if issue:
            spans.mark_issued()
        time.sleep(dur / 2)
        return state

    def gap(state):
        time.sleep(host_gap)
        return state
    return [Segment(f"{name}/layer", fn, host_work=gap if host_gap else None)
            for _ in range(n)]


def test_one_row_per_request_with_its_stamps_in_order():
    """A high service with host gaps, served through the async path (its
    host work runs on the device thread), and a low one that fills them:
    one row a request, every stamp in order, the fills flagged."""
    hi_key, lo_key = TaskKey("spans-hi"), TaskKey("spans-lo")
    hi_segs = _segments("spans-hi", 5, 0.002, host_gap=0.006)
    lo_segs = _segments("spans-lo", 8, 0.002, issue=False)
    pd = ProfiledData()
    for key, segs in ((hi_key, hi_segs), (lo_key, lo_segs)):
        prof = Profiler(key)
        with WallClockEngine(Mode.EXCLUSIVE) as eng:
            for _ in range(3):
                HookClient(eng, key, 0, segs).measure_run("x", prof)
        pd.load(prof.statistics())

    spans.clear()
    done = threading.Event()
    with WallClockEngine(Mode.FIKIT, pd) as eng:
        hi = HookClient(eng, hi_key, 0, hi_segs)
        lo = HookClient(eng, lo_key, 5, lo_segs)
        t = threading.Thread(target=lambda: lo.run("x"))
        t.start()
        time.sleep(0.004)
        inst = hi.run_async("x", lambda *_: done.set())
        assert done.wait(timeout=10)
        t.join(timeout=10)
        assert not t.is_alive()
        fills = eng.fill_count
        n_records = len(eng.records())
    rows = [r for r in spans.rows() if r.kernel.startswith("spans-")]
    assert len(rows) == n_records == 13
    assert sorted((r.kernel, r.seq) for r in rows) == sorted(
        [("spans-hi/layer", i) for i in range(5)]
        + [("spans-lo/layer", i) for i in range(8)])
    assert {r.instance for r in rows if r.priority == 0} == {inst}
    for r in rows:
        assert r.submit <= r.got <= r.start <= r.issued <= r.end
        assert r.end <= r.booked <= r.done
        assert r.asked <= r.got
    for r in rows:
        if r.kernel == "spans-lo/layer":
            assert r.issued == r.end          # never marked: its end
        else:
            assert r.issued < r.end
    # the high service's 6 ms gap runs in its completion callback
    hi_rows = [r for r in rows if r.priority == 0]
    assert all(r.done - r.booked >= 0.005 for r in hi_rows[:-1])
    assert fills > 0
    assert sum(r.filler for r in rows) == fills
    assert all(r.priority == 5 for r in rows if r.filler)
    assert spans.dropped() == 0


def test_rows_since_and_the_issued_slot():
    spans.clear()
    # a segment called outside an engine (another test file's, on this
    # worker's thread) leaves its stamp in the slot: empty it first
    spans.take_issued(0.0)
    for i in range(4):
        spans.record(_row(i, start=float(i)))
    assert [r.instance for r in spans.rows(since=2.0)] == [2, 3]
    assert spans.take_issued(7.0) == 7.0
    spans.mark_issued()
    t = spans.take_issued(7.0)
    assert t != 7.0 and t <= time.perf_counter()
    assert spans.take_issued(7.0) == 7.0     # emptied by the take
    spans.clear()
    assert spans.rows() == [] and spans.dropped() == 0


def test_the_ring_is_bounded_and_counts_what_it_overwrote():
    spans.clear()
    for i in range(spans.CAPACITY + 5):
        spans.record(_row(i))
    rows = spans.rows()
    assert len(rows) == spans.CAPACITY
    assert spans.dropped() == 5
    assert rows[0].instance == 5 and rows[-1].instance == spans.CAPACITY + 4
    spans.clear()
    assert spans.dropped() == 0


def test_threads_lose_no_row():
    """More writers than cores, switching often: every row is either held
    or counted as overwritten."""
    writers, each = 16, spans.CAPACITY // 8
    spans.clear()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [spans.record(_row()) for _ in range(each)])
            for _ in range(writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(spans.rows()) == spans.CAPACITY
    assert spans.dropped() == writers * each - spans.CAPACITY
    spans.clear()


def test_a_run_request_no_longer_holds_its_input():
    """The engine's record keeps each request, but not the input its
    payload was bound to."""
    x = torch.zeros(1024)
    alive = weakref.ref(x)

    def fn(state):
        return state + 1
    with WallClockEngine(Mode.SHARING) as eng:
        client = HookClient(eng, TaskKey("spans-input"), 0,
                            [Segment("spans-input/layer", fn)] * 2)
        out, _ = client.run(x)
    del x, out
    gc.collect()
    assert len(eng.records()) == 2
    assert all(r.req.payload is None for r in eng.records())
    assert alive() is None
