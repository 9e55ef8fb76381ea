"""The most any high send ran behind its due time (host clock)."""


def read(run):
    return 1e3 * run.gen_lag_s
