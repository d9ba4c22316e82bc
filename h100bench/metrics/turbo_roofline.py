"""turbo_roofline: the fused turbo pass's bound (``roofline.turbo``, the
active segments by the reference tracer) over the device time of the
fused turbo kernel in the traced window, in %."""
from h100bench import roofline


def read(run):
    if run.trace is None or run.entry_name != "formod":
        return None
    t = sum(v for k, v in run.trace.kernel_ns.items()
            if "ega_fused_kernel" in k and "TurboCorner" in k) / 1e9
    if t <= 0:
        return None
    c = run.cfg
    G, W, D = len(c["emitters"]), 1, int(c["nd"])
    R, S = run.inputs.nr, int(c["nlos"])
    b = sum(roofline.turbo(n, R, S, G, W, D, int(c["tblnp"]),
                           int(c["tblnt"]), int(c["tblnu"]),
                           run.inputs.ft["st"].size)[0]
            for n in run.segments())
    return 100.0 * b / t
