"""Device ms per batch of the Haar cascade's stage kernel
(``csrc/haar_cascade.cu``): the kernels whose demangled names hold
``haar_cascade``, from the profiled window (one batch per call).  None
where no such kernel ran, as in a program without it."""

NAME = "haar_cascade"


def read(run):
    tl = run.timeline
    if tl is None or not run.profiled_calls:
        return None
    kernels = tl.kernels(name_has=NAME)
    if not kernels:
        return None
    return sum(k.end - k.start for k in kernels) * 1e-3 / run.profiled_calls
