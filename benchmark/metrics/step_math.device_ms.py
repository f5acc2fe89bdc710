"""Device ms per tracker step outside the fused match: every kernel the
profiled window ran (window slices, the NCC's matmuls and epilogue, crop
gathers, argmax) less ``fused_match_products`` and ``fused_match_finish``,
per call.  The profiler names kernels by their demangled signatures
(``void (anonymous namespace)::fused_match_products<true, 128>(...)``), so
the two are told by a part of the name."""

FUSED = ("fused_match_products", "fused_match_finish")


def read(run):
    tl = run.timeline
    if tl is None or not run.profiled_calls:
        return None
    kernels = tl.kernels()
    if not kernels:
        return None
    rest = [k for k in kernels if not any(name in k.name for name in FUSED)]
    return sum(k.end - k.start for k in rest) * 1e-3 / run.profiled_calls
