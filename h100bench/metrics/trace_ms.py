"""trace_ms: the tracer per ``formod`` call, the mean over the window of
the program's phase split (``trace``: from the profiles' end to the
tracer's end on the stream)."""


def read(run):
    if not run.phases:
        return None
    return sum(p.get("trace", 0.0) for p in run.phases) / len(run.phases)
