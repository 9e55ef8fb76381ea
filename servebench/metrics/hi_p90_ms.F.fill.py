"""90th percentile latency of the high requests due in the window, over
all of them (host clock), in a cell that reports no high latency end to
end."""
from servebench.stats import latency_ms


def read(run):
    return latency_ms(run, "high", 0.9)
