"""Peaks of the card and the least time each measured piece of work needs.

A roofline share is the least time the card could take (the larger of
operations over the peak rate and bytes over the peak bandwidth) divided
by the measured time, so it cannot pass 100% unless the counts or the time
are wrong.  Operations are counted once, against the card's highest dense
rate, so that no choice of precision or of algorithm can read above 100%;
bytes count each input read once and each output written once.
"""

from __future__ import annotations

import math
from typing import NamedTuple

# One H100 SXM at 700 W, NVIDIA's data sheet: dense bf16 tensor-core
# FLOP/s, the highest dense rate for floating-point products, and HBM3
# bytes/s.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


class Bound(NamedTuple):
    flops: float
    bytes: float

    @property
    def seconds(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)

    @property
    def by(self) -> str:
        return "operations" if self.flops / PEAK_FLOPS >= self.bytes / PEAK_BYTES else "bytes"


def fused_match(b: int, d: int, k: int, n: int) -> Bound:
    """The fused projection-and-match of ``b`` crops of ``d`` float32
    pixels against a (d, k) projection and an ``n``-row gallery: the two
    products, and the crops, the projection, the bias, the gallery and its
    norms read once, a row and a score per crop written once."""
    flops = 2.0 * b * d * k + 2.0 * b * k * n
    read = 4.0 * (b * d + d * k + k + k * n + n)
    return Bound(flops, read + 8.0 * b)


def fft2_flops(n: int) -> float:
    """A real 2-D FFT of n x n points: 2.5 N log2 N for N = n * n."""
    points = n * n
    return 2.5 * points * math.log2(points)


def tracker_frame_flops(win: int, tpl: int, k: int, n: int) -> float:
    """The least arithmetic one stream's frame needs on the tracker's path,
    whatever computes it: the correlation of the window with the template
    by FFT (the template's spectrum made once), the window's box sums of
    pixels and squares, the normalised scores, the crop's projection and
    its cosines with the gallery.  Any other NCC algorithm does more, so a
    share of the peak taken from this count bounds the whole step."""
    out = win - tpl + 1
    ncc = 2 * fft2_flops(win) + 6.0 * win * (win // 2 + 1)
    boxes = 5.0 * win * win
    scores = 10.0 * out * out
    match = 2.0 * tpl * tpl * k + 2.0 * k * n + 3.0 * n
    return ncc + boxes + scores + match
