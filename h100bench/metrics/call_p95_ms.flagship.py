"""call_p95_ms.flagship: the 95th percentile of the host latency of the
traced window's ``formod`` calls (the profiler on; where the host paces
the call, its tail is the host's)."""
import numpy as np


def read(run):
    if run.trace is None or not run.done:
        return None
    return float(np.percentile(run.calls_ms, 95))
