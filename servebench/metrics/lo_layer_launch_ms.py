"""Median over the low service's ``layer`` segments that started in the
window of ``issued - start`` (the program's rows): the host time to issue
one layer's kernels, before the segment waits for the card."""
from servebench import program_spans


def read(run):
    return program_spans.layer_launch_ms(run, "low")
