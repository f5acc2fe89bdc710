"""Device ms per batch of the kernels the host launched inside the
detector's span: the level resizes, integrals, dense and candidate
stages and compactions of ``detect/haar``, from the profiled window (one
batch per call)."""


def read(run):
    tl = run.timeline
    if tl is None or not run.profiled_calls:
        return None
    kernels = tl.kernels(span="haar.detect")
    if not kernels:
        return None
    return sum(k.end - k.start for k in kernels) * 1e-3 / run.profiled_calls
