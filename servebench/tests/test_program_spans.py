"""The readers of the program's own spans (``program_spans`` and the six
metrics over it), on hand-built rows of the port's recorder and a
hand-built device trace."""
import random
import sys
from types import SimpleNamespace

import pytest

from repro_torch import spans
from servebench import program_spans
from servebench.catalog import load_metric
from servebench.trace import Trace

METRICS = ("hi_engine_wait_ms", "hi_layer_launch_ms", "lo_layer_launch_ms",
           "idle_launch_share", "idle_host_share", "idle_wait_share")
SHARES = METRICS[3:]
HI, LO = 0, 5

#: one device thread's timeline in the window [10, 20]: (instance, seq,
#: priority, kernel, submit, asked, got, start, issued, end, booked, done)
TIMELINE = [
    (1, 0, LO, "lo/layer", 4.0, 4.0, 4.0, 5.0, 9.0, 9.5, 9.5, 9.6),
    (2, 0, HI, "hi/embed", 10.0, 9.5, 10.0, 10.0, 10.2, 10.5, 10.5, 10.6),
    (5, 0, LO, "lo/layer", 10.1, 10.6, 10.6, 10.6, 11.0, 11.2, 11.2, 11.3),
    (2, 1, HI, "hi/layer", 10.55, 11.3, 11.3, 11.3, 11.8, 12.0, 12.0, 12.5),
    (2, 2, HI, "hi/head", 12.5, 12.5, 12.5, 12.5, 12.6, 13.0, 13.0, 13.1),
    (5, 1, LO, "lo/layer", 15.0, 13.1, 15.0, 15.0, 15.6, 16.0, 16.0, 16.0),
    (3, 0, HI, "hi/embed", 16.0, 16.0, 16.0, 16.1, 16.2, 16.4, 16.4, 16.5),
    (3, 1, HI, "hi/layer", 16.5, 16.5, 16.5, 16.7, 17.0, 17.2, 17.2, 17.4),
    (3, 2, HI, "hi/head", 17.4, 17.4, 17.4, 17.4, 17.5, 17.6, 17.6, 17.7),
    (4, 0, HI, "hi/embed", 19.4, 17.7, 19.4, 19.5, 19.6, 19.8, 19.8, 19.9),
]
#: the device busy from each segment's issue to its end
BUSY = [(10.2, 10.5), (11.0, 11.2), (11.8, 12.0), (12.6, 13.0), (15.6, 16.0),
        (16.2, 16.4), (17.0, 17.2), (17.5, 17.6), (19.6, 19.8)]


def _record(timeline):
    spans.clear()
    for inst, seq, prio, kernel, *stamps in timeline:
        spans.record(spans.Row(0, inst, seq, prio, False, kernel, *stamps))


def _run(t0, t1, busy):
    ops = [("k", a, b) for a, b in busy]
    mix = {"high": {"priority": HI}, "low": {"priority": LO}}
    return SimpleNamespace(t0=t0, t1=t1, trace=Trace(t0, t1, ops),
                           cell=SimpleNamespace(mix=mix))


def _read(name, run):
    return load_metric(name)(run)


@pytest.fixture
def timeline():
    _record(TIMELINE)
    yield _run(10.0, 20.0, BUSY)
    spans.clear()


def test_each_reader_gives_its_known_answer(timeline):
    run = timeline
    # instance 2 waited 0 + 0.75 + 0 s, instance 3 0.1 + 0.2 + 0 s;
    # instance 4 is held only in part, instance 5 is low
    assert _read("hi_engine_wait_ms", run) == pytest.approx(525.0)
    # layers started in the window: high 0.5 and 0.3 s, low 0.4 and 0.6 s
    # (the low row that started before the window is not read)
    assert _read("hi_layer_launch_ms", run) == pytest.approx(400.0)
    assert _read("lo_layer_launch_ms", run) == pytest.approx(500.0)
    # busy 2.2 s of 10: idle 7.8 s, of which launching 2.4 s, host work
    # 1.3 s, the thread waiting on its queue 3.6 s (13.1-15.0, 17.7-19.4)
    idle = 7.8
    assert _read("idle_launch_share", run) == pytest.approx(100 * 2.4 / idle)
    assert _read("idle_host_share", run) == pytest.approx(100 * 1.3 / idle)
    assert _read("idle_wait_share", run) == pytest.approx(100 * 3.6 / idle)


def test_the_shares_sum_to_at_most_100(timeline):
    assert sum(_read(m, timeline) for m in SHARES) <= 100.0


@pytest.mark.parametrize("seed", range(5))
def test_the_shares_sum_to_at_most_100_on_random_timelines(seed):
    """A device thread's rows one after another, the card busy in parts of
    each [issued, end]."""
    rnd = random.Random(seed)
    at, timeline, busy = 0.0, [], []
    for i in range(200):
        asked = at
        got = start = asked + rnd.expovariate(100)
        issued = start + rnd.uniform(0.001, 0.004)
        end = issued + rnd.uniform(0.0005, 0.002)
        busy.append((rnd.uniform(issued - 0.0005, issued), end))
        done = end + rnd.choice((0.0, rnd.uniform(0.0, 0.003)))
        prio = rnd.choice((HI, LO))
        timeline.append((i, 0, prio, "x/layer", asked, asked, got, start,
                         issued, end, end, done))
        at = done
    _record(timeline)
    run = _run(timeline[10][7], timeline[-10][7], busy)
    shares = [_read(m, run) for m in SHARES]
    assert all(s is not None and s >= 0 for s in shares)
    assert sum(shares) <= 100.0 + 1e-9
    spans.clear()


def test_a_gap_covered_by_a_segment_of_a_later_name_is_counted():
    """Busy [0, 1] and [2, 3]; a low segment issues its kernels over the
    whole gap [1, 2], between high segments at [0, 0.5] and [2.5, 2.6]:
    its launch covers the gap, whatever the names sort as."""
    _record([
        (9, 0, HI, "hi/layer", -2.0, -2.0, -2.0, -2.0, -1.5, -1.2, -1.2, -1.1),
        (1, 1, HI, "hi/layer", 0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.5, 0.5),
        (2, 1, LO, "lo/layer", 0.5, 0.5, 0.5, 1.0, 2.0, 2.2, 2.2, 2.2),
        (1, 2, HI, "hi/layer", 2.2, 2.2, 2.2, 2.5, 2.5, 2.6, 2.6, 2.6),
    ])
    run = _run(0.0, 3.0, [(0.0, 1.0), (2.0, 3.0)])
    assert _read("idle_launch_share", run) == pytest.approx(100.0)
    assert _read("idle_host_share", run) == pytest.approx(0.0)
    spans.clear()


def test_no_reading_once_the_window_s_first_rows_were_overwritten(timeline):
    later = spans.Row(0, 0, 0, LO, False, "lo/layer", *([30.0] * 8))
    for _ in range(spans.CAPACITY - len(TIMELINE) + 2):
        spans.record(later)
    assert spans.dropped() == 2
    # the oldest row held now finished inside the window
    assert spans.rows()[0].done >= timeline.t0
    assert all(_read(m, timeline) is None for m in METRICS)


def test_no_reading_without_the_program_s_recorder(timeline, monkeypatch):
    """A program whose engine records no rows (no ``repro_torch.spans``),
    as a tree before the recorder: every reader gives None, none raises."""
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert all(_read(m, timeline) is None for m in METRICS)


def test_no_share_without_a_device_trace(timeline):
    timeline.trace = None
    assert all(_read(m, timeline) is None for m in SHARES)
    assert _read("hi_layer_launch_ms", timeline) == pytest.approx(400.0)


def test_overlaps():
    assert program_spans.overlap([(0, 2), (3, 4)],
                                 [(1, 3.5), (3.8, 9)]) == pytest.approx(1.7)
