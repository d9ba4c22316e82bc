"""device_idle.jacobian: the share of the traced window of
``kernel_autodiff`` calls in which no device activity ran, in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
