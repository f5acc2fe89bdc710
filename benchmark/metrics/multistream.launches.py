"""Host launch calls (kernel launches, copies and sets put on the card's
queue) per tracker step inside the program's ``multistream.step`` span,
counted in the profiled window from the trace's host operations."""

from benchmark import stages


def read(run):
    return stages.launches_per_step(run.timeline)
