"""k_d2h_gbps: the rate of K's copy to the host, GB/s: the bytes of K
the program counted (``k_bytes``) over the stream time of its ``K to
host`` spans, summed over the window's ``kernel_autodiff`` records of
the model's ``phase_log``."""


def read(run):
    recs = [p for p in run.phases
            if getattr(p, "root", None) == "kernel_autodiff"]
    ms = sum(p.get("K to host", 0.0) for p in recs)
    if ms <= 0:
        return None
    return sum(p.counts["k_bytes"] for p in recs) / 1e9 / (ms / 1e3)
