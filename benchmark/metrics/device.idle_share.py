"""The share of the profiled window's wall time in which no kernel, copy
or set ran on the card, in %."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0 or not tl.ops:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
