"""Per cent of the window's device-idle time that lies inside some
segment's [``start``, ``issued``] (the program's rows over the device
trace): the card waits while the host issues a segment's kernels."""
from servebench import program_spans


def read(run):
    return program_spans.idle_share(run, "start", "issued")
