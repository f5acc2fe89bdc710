"""The whole tracker step's share of the card's peak, in %: the least
arithmetic a frame needs on the tracker's path whatever computes it
(``roofline.tracker_frame_flops``: NCC by FFT, box sums, scores, the
crop's projection and cosines), times the frames per second of the timed
window, over the card's highest dense rate.  A later change that takes a
kernel off the path leaves that kernel's roofline silent; this share
still bounds the step."""

from benchmark import roofline


def read(run):
    if not run.window_s:
        return None
    c = run.config
    flops = roofline.tracker_frame_flops(c["window"], c["template"], c["components"], c["gallery"])
    return 100.0 * flops * run.frames / run.window_s / roofline.PEAK_FLOPS
