"""Prompt tokens of the low forwards that completed in the window, over
the window's seconds (host clock)."""


def read(run):
    B, S = run.shape("low")
    return B * S * len(run.completed_in_window("low")) / run.seconds
