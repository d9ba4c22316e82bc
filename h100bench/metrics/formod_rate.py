"""formod_rate: rays x channels of every ``formod`` call completed in the
window, over the window's seconds (host clock)."""


def read(run):
    if not run.done:
        return None
    return run.done * run.work / run.window_s
