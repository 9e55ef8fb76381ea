"""Fills (low segments the FIKIT scheduler placed into the high service's
gaps) over the low segments that ran in the window, in per cent."""


def read(run):
    ran = [s for s in run.window_spans("low/")
           if not s[0].endswith((".gap", ".sample"))]
    return 100.0 * run.fills / len(ran) if ran else None
