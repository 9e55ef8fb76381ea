"""Per cent of the window's device-idle time that lies inside some
segment's [``asked``, ``got``] (the program's rows over the device
trace): the device thread blocked on an empty queue."""
from servebench import program_spans


def read(run):
    return program_spans.idle_share(run, "asked", "got")
