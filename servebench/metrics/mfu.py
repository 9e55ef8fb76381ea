"""Model operations of every forward of both services completed in the
window, over the window's seconds at the H100's bf16 peak, in per cent
(the benchmark's own counts from shapes, ``servebench/flops.py``)."""
from servebench.flops import PEAK_BF16_FLOPS, forward_flops


def read(run):
    ops = 0
    for role in ("high", "low"):
        B, S = run.shape(role)
        ops += (forward_flops(run.cfg(role), B, S)
                * len(run.completed_in_window(role)))
    return 100.0 * ops / (run.seconds * PEAK_BF16_FLOPS) if ops else None
