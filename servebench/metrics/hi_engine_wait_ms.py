"""Median, over the high requests whose last segment ended in the window,
of the time their segments waited in the engine: the sum over a
request's segments of ``start - submit`` (the program's rows, one per
kernel request), in the priority queues and behind other work on the
device thread."""
from servebench import program_spans


def read(run):
    reqs = program_spans.requests(run, "high")
    if reqs is None:
        return None
    return program_spans.median_ms(sum(r.start - r.submit for r in segs)
                                   for segs in reqs)
