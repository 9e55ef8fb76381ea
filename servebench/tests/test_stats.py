"""Tail latency over all requests from their due time, and the window's
token rate."""
import math
from types import SimpleNamespace

from servebench.harness import Request, Run
from servebench.stats import latency_ms, percentile


class Ticket(SimpleNamespace):
    outcome = "completed"


def request(due, latency):
    t = None
    if latency is not None:
        # the plane's ticket: arrival is the due time the sender passed
        t = Ticket(arrival=due, latency=latency)
    return Request(0, due, t)


def fake_run(high, low, seconds=10.0):
    cell = SimpleNamespace(mix={"low": {"batch": 4, "seq": 256},
                                "high": {"batch": 2, "seq": 8}})
    run = Run(cell, {}, seconds)
    run.t0 = 100.0
    run.high, run.low = high, low
    return run


def test_percentile_interpolates_over_all_values():
    v = list(range(1, 101))
    assert percentile(v, 0.5) == 50.5
    assert math.isclose(percentile(v, 0.9), 90.1)
    assert percentile([3.0], 0.9) == 3.0


def test_latency_is_from_due_time_and_missing_counts_as_late():
    high = [request(100.0 + i, 0.1 * (i + 1)) for i in range(9)]
    run = fake_run(high + [request(109.0, None)], [])
    # nine done at 0.1..0.9 s, one never: the median is between 0.5 and
    # 0.6 s, and the 90th percentile falls on the missing one
    assert math.isclose(latency_ms(run, "high", 0.5), 550.0)
    assert latency_ms(run, "high", 0.9) is None
    run = fake_run(high, [])
    assert math.isclose(latency_ms(run, "high", 0.9), 820.0)


def test_token_rate_counts_forwards_done_inside_the_window():
    from servebench.catalog import load_metric
    low = [request(99.0, 0.5),      # done 99.5: before the window
           request(100.0, 2.0),     # done 102: inside
           request(105.0, 4.0),     # done 109: inside
           request(108.0, 3.0),     # done 111: after the close
           request(109.0, None)]    # never done
    run = fake_run([], low)
    assert load_metric("lo_tokens_per_s")(run) == 2 * 4 * 256 / 10.0
