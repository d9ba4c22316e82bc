"""profiles_ms: the host's hydrostatics and ray profiles (with their
host-to-device copy) per ``formod`` call, the mean over the window of the
program's phase split (``ForwardModel.phase_log``: hydrostatics +
profiles)."""


def read(run):
    if not run.phases:
        return None
    return sum(p.get("hydrostatics", 0.0) + p.get("profiles", 0.0)
               for p in run.phases) / len(run.phases)
