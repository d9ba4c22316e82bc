"""assemble_ms: the host's work per ``formod`` call after the one pull
(entry flags, the hybrid's re-run and splice, the output fields, the FOV
convolution and the mask), the mean over the window of the program's
spans ``hybrid re-run + D2H``, ``host`` and ``FOV + mask`` (``formod``
records of ``ForwardModel.phase_log``)."""


def read(run):
    recs = [p for p in run.phases if getattr(p, "root", None) == "formod"]
    if not recs:
        return None
    return sum(p.get(s, 0.0) for p in recs
               for s in ("hybrid re-run + D2H", "host", "FOV + mask")) / len(recs)
