"""Share of the traced window with no operation running on the device,
in per cent (``torch.profiler``, CUDA activity)."""


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
