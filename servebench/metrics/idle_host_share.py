"""Per cent of the window's device-idle time that lies inside some
segment's [``end``, ``done``] (the program's rows over the device trace):
the device thread's bookkeeping under the engine lock, then the
completion callback, which holds the client's host work (the injected
gap, the head's sampling) and the submit of its next segment."""
from servebench import program_spans


def read(run):
    return program_spans.idle_share(run, "end", "done")
