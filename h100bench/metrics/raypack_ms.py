"""raypack_ms: the RAYPACK sizing per ``formod`` call (``package_size``
with its read of the card's free memory, and the package loop's stream
set-up), the mean over the window of the program's ``raypack sizing``
span (``formod`` records of ``ForwardModel.phase_log``)."""


def read(run):
    recs = [p for p in run.phases if getattr(p, "root", None) == "formod"]
    if not recs:
        return None
    return sum(p.get("raypack sizing", 0.0) for p in recs) / len(recs)
