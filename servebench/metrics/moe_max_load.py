"""The most entries any one expert of a layer received over the mean
(entries over experts), as the median over the low model's MoE layers:
the port's device-side routing counters (``repro_torch.spans
.moe_counts``), which count every served forward of the process, the
set-up's included. None where the program has no such counter or the low
model routed nothing."""
import statistics


def read(run):
    try:
        from repro_torch import spans
    except ImportError:
        return None
    counts = getattr(spans, "moe_counts", None)
    if counts is None:
        return None
    name = run.cfg("low")["name"]
    loads = [max(c.routed) * len(c.routed) / sum(c.routed)
             for c in counts() if c.model == name and sum(c.routed)]
    return statistics.median(loads) if loads else None
