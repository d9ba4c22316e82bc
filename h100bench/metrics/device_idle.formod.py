"""device_idle.formod: the share of the traced window of ``formod`` calls
in which no device activity ran (1 - the union of the profiler's device
intervals over the window), in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
