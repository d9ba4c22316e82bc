"""k_to_host_ms: K to the host per ``kernel_autodiff`` call (the masked
row select on the device, the copy of K's rows and the entry flags to
the host, the rows' assembly), the mean over the window of the
program's spans ``K gather``, ``K to host`` and ``K assembly``
(``kernel_autodiff`` records of the model's ``phase_log``)."""


def read(run):
    recs = [p for p in run.phases
            if getattr(p, "root", None) == "kernel_autodiff"]
    if not recs:
        return None
    return sum(p.get(s, 0.0) for p in recs
               for s in ("K gather", "K to host", "K assembly")) / len(recs)
