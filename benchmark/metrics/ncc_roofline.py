"""The tracker's NCC kernel's share of its roofline, in %: the least time
the card needs for the locate's work on a step's windows over the time the
kernels whose demangled names hold ``ncc_locate`` cover per call in the
profiled window.  The work of a window of side w with a template of side
t (out = w - t + 1): two real 2-D FFTs of w x w (``roofline.fft2_flops``),
the spectrum product 6 w (w/2 + 1), the box sums 5 w^2 and the scores
10 out^2 operations; bytes: the windows read once, the template's half
spectrum (w x (w/2 + 1) complex float32) once and 12 bytes out a window.
None where no such kernel ran, as in a program without it.  Prints which
bound applies."""

import sys

from benchmark import roofline
from benchmark.timeline import union_s

NAME = "ncc_locate"


def bound(streams: int, win: int, tpl: int) -> roofline.Bound:
    out = win - tpl + 1
    per_window = (2 * roofline.fft2_flops(win) + 6.0 * win * (win // 2 + 1) + 5.0 * win * win
                  + 10.0 * out * out)
    read = 4.0 * streams * win * win + 8.0 * win * (win // 2 + 1)
    return roofline.Bound(streams * per_window, read + 12.0 * streams)


def read(run):
    tl = run.timeline
    kernels = tl.kernels(NAME) if tl is not None else []
    if not kernels:
        return None
    b = bound(run.traffic["streams"], run.config["window"], run.config["template"])
    print(f"ncc_roofline: the bound is {b.seconds * 1e6:.3f} us per call, by {b.by}",
          file=sys.stderr)
    return 100.0 * b.seconds * len(kernels) / union_s(kernels)
