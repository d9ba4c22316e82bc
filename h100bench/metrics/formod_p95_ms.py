"""formod_p95_ms: the 95th percentile of the host latency of every
``formod`` call in the window, from the call to its host-side result."""
import numpy as np


def read(run):
    if not run.done:
        return None
    return float(np.percentile(run.calls_ms, 95))
