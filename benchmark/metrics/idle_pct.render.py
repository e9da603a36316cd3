"""Device: the share of the traced window in which no operation ran on it,
in the render cells."""


def read(run):
    if run.trace is None or not run.trace.n_ops:
        return None
    return 100.0 * (1 - run.trace.busy_s / run.trace.window_s)
