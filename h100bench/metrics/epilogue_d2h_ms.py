"""epilogue_d2h_ms: the forward epilogue (surface term, where the fused
pass runs it apart) and the one device-to-host copy per ``formod`` call,
the mean over the window of the program's phase split (epilogue +
D2H)."""


def read(run):
    if not run.phases:
        return None
    return sum(p.get("epilogue", 0.0) + p.get("D2H", 0.0)
               for p in run.phases) / len(run.phases)
