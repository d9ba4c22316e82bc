"""jvp_roofline: the summed bounds of the Jacobian's four tangent passes
on exact tables (``roofline.jacobian_exact``: the tracer, its tangents,
the RT record pass, the contraction) over the summed device time of the
four kernels that run them (``trace_jvp_record_kernel``,
``trace_jvp_tangent_kernel``, ``ega_rec_kernel``, ``ega_jvp_contract``)
in the traced window, in %."""
from h100bench import roofline

KERNELS = ("trace_jvp_record_kernel", "trace_jvp_tangent_kernel",
           "ega_rec_kernel", "ega_jvp_contract")


def read(run):
    if run.trace is None or run.entry_name != "jacobian":
        return None
    t = run.trace.kernel_s(*KERNELS)
    if t <= 0:
        return None
    c, inp = run.cfg, run.inputs
    G, W, D = len(c["emitters"]), 1, int(c["nd"])
    b = 8 if c["dtype"] == "float64" else 4
    N = inp.pool[0]["z"].size
    n = run.work // (inp.nr * D)
    bound = 0.0
    for na in run.segments():
        parts = roofline.jacobian_exact(
            na, inp.nr, int(c["nlos"]), N, N, n, G, W, D, int(c["tblnp"]),
            int(c["tblnt"]), int(c["tblnu"]), inp.ft["st"].size, b)
        bound += sum(v[0] for v in parts.values())
    return 100.0 * bound / t
