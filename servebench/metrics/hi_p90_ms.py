"""90th percentile latency of the high requests due in the window, over
all of them (host clock)."""
from servebench.stats import latency_ms


def read(run):
    return latency_ms(run, "high", 0.9)
