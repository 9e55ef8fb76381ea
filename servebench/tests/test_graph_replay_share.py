"""``graph_replay_share`` over the port's graph counter: its known answer
from the counter's deltas, and no reading (never an error) where the
program has no counter, as a tree before it, or ran no CUDA segment."""
import sys
from types import SimpleNamespace

import pytest

from repro_torch import spans
from servebench.catalog import load_metric


def _read():
    return load_metric("graph_replay_share")(SimpleNamespace())


def test_the_share_of_replayed_calls(monkeypatch):
    counts = {"captured": 52, "replayed": 9948, "eager": 52}
    monkeypatch.setattr(spans, "graph_counts", lambda: dict(counts))
    assert _read() == pytest.approx(100.0 * 9948 / 10000)
    counts.update(replayed=0, eager=0)
    assert _read() is None


def test_the_counter_counts_what_the_reader_reads(monkeypatch):
    monkeypatch.setattr(spans, "_graph_events",
                        dict.fromkeys(spans.GRAPH_EVENTS, 0))
    for event in ("captured", "eager", "replayed", "replayed", "replayed"):
        spans.count_graph(event)
    spans.clear()                     # the ring's, not the counter's
    assert spans.graph_counts() == {"captured": 1, "replayed": 3,
                                    "eager": 1}
    assert _read() == pytest.approx(75.0)


def test_no_reading_without_the_counter(monkeypatch):
    monkeypatch.delattr(spans, "graph_counts")
    assert _read() is None
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert _read() is None
