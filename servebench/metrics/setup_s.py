"""Process start to the first due request: imports, the built kernels'
loading, weights, warm-up and onboarding (host clock)."""


def read(run):
    return run.setup_s
