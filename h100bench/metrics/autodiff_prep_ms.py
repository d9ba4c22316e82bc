"""autodiff_prep_ms: the Jacobian's set-up per ``kernel_autodiff`` call
(the state map's seed, the package sizing, each package's profiles and
tangents), the mean over the window of the program's spans ``seed``,
``sizing`` and ``package tangents`` (``kernel_autodiff`` records of the
model's ``phase_log``)."""


def read(run):
    recs = [p for p in run.phases
            if getattr(p, "root", None) == "kernel_autodiff"]
    if not recs:
        return None
    return sum(p.get(s, 0.0) for p in recs
               for s in ("seed", "sizing", "package tangents")) / len(recs)
