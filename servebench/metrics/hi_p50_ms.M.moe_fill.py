"""Median latency of the high requests due in the window (host clock), as
a per-layer reading where its spread from process to process is too wide
for an end-to-end bound."""
from servebench.stats import latency_ms


def read(run):
    return latency_ms(run, "high", 0.5)
