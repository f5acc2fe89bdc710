"""Frames per second of the timed window, on the host clock: the frames of
every call in the window over the window's seconds, as the end-to-end
``frames_per_s``.  It stands as a per-layer metric where the host sets
the pace and its runs spread too widely to hold a bound end to end."""


def read(run):
    return run.frames / run.window_s if run.window_s else None
