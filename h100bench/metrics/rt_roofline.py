"""rt_roofline: the exact-table RT pass's bound (``roofline.rt_exact``,
the active segments by the reference tracer) over the device time of the
RT kernel (``ega_rt_kernel_exact``) in the traced window, in %."""
from h100bench import roofline


def read(run):
    if run.trace is None or run.entry_name != "formod":
        return None
    t = run.trace.kernel_s("ega_rt_kernel_exact")
    if t <= 0:
        return None
    c = run.cfg
    G, W, D = len(c["emitters"]), 1, int(c["nd"])
    b = 8 if c["dtype"] == "float64" else 4
    bound = sum(roofline.rt_exact(n, run.inputs.nr, int(c["nlos"]), G, W, D,
                                  int(c["tblnp"]), int(c["tblnt"]),
                                  int(c["tblnu"]), run.inputs.ft["st"].size,
                                  b)[0]
                for n in run.segments())
    return 100.0 * bound / t
