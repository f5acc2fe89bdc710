"""Normalized cross-correlation: ``cv2.matchTemplate`` TM_CCOEFF_NORMED
on tensors (port of ``ops/match.py``).

    R(x,y) = sum_T' . I_win  /  sqrt(sum T'^2 * (sum I_win^2 - (sum I_win)^2/n))

with T' = T - mean(T).  Because sum(T') == 0 the numerator is the
cross-correlation of the frame with the zero-meaned template, and the
window statistics come from two integral images (:mod:`.integral`).  The
numerator has two routes: ``direct`` is one ``conv2d`` (in full float32,
under :func:`..device.exact_float32`) for the small templates of the
guided scanner's search windows, and ``fft`` is an ``rfft2`` product at
5-smooth sizes for big templates.

``minMaxLoc`` parity: OpenCV scans row-major and keeps the first
maximum; :func:`min_max_loc` does the same.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from face_detection_recognization_pca_tpu_torch.device import exact_float32
from face_detection_recognization_pca_tpu_torch.ops.integral import (
    integral_image,
    window_sums,
)


def _xcorr_direct(frame: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation as one convolution."""
    with exact_float32():
        return F.conv2d(frame[None, None], kernel[None, None])[0, 0]


def _next_fast_len(n: int) -> int:
    """Smallest 5-smooth number >= n (good FFT sizes)."""
    best = 1 << (n - 1).bit_length()
    f5 = 1
    while f5 < best:
        f35 = f5
        while f35 < best:
            x = f35
            while x < n:
                x *= 2
            best = min(best, x)
            f35 *= 3
        f5 *= 5
    return best


def _xcorr_fft(frame: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation via rFFT (for large templates).  The
    transforms are float32 whatever the frame's dtype, as in the JAX
    package."""
    fh, fw = frame.shape
    kh, kw = kernel.shape
    size = (_next_fast_len(fh), _next_fast_len(fw))
    f = torch.fft.rfft2(frame.to(torch.float32), s=size)
    # Correlation = conv with flipped kernel => conjugate in Fourier.
    k = torch.fft.rfft2(kernel.to(torch.float32), s=size)
    out = torch.fft.irfft2(f * torch.conj(k), s=size)
    return out[: fh - kh + 1, : fw - kw + 1].to(frame.dtype)


def _xcorr(method: str, n: int):
    if method == "auto":
        # Direct convolution only for small templates, where the FFT's
        # padding dominates.
        method = "direct" if n <= 32 * 32 else "fft"
    return _xcorr_direct if method == "direct" else _xcorr_fft


def match_template_ccoeff_normed(
    frame: torch.Tensor,
    template: torch.Tensor,
    method: str = "auto",
    eps: float = 1e-7,
) -> torch.Tensor:
    """TM_CCOEFF_NORMED score map of an ``(H, W)`` frame and an ``(h, w)``
    template over all valid positions: ``(H - h + 1, W - w + 1)`` scores
    in [-1, 1].  ``method`` is ``"direct"``, ``"fft"`` or ``"auto"`` (by
    template area).  Flat windows give 0, as in OpenCV."""
    dtype = torch.promote_types(frame.dtype, torch.float32)
    f = frame.to(dtype)
    # Global-mean centring: the score is invariant to it (the zero-mean
    # template kills the constant in the numerator and the window variance
    # is shift-invariant), and it avoids float32 cancellation in
    # s2 - s1^2/n.
    f = f - f.mean()
    t = template.to(dtype)
    th, tw = t.shape
    n = th * tw

    t0 = t - t.mean()
    t_energy = (t0 * t0).sum()
    num = _xcorr(method, n)(f, t0)

    s1 = window_sums(integral_image(f, dtype), (th, tw))
    s2 = window_sums(integral_image(f * f, dtype), (th, tw))
    win_var_n = torch.clamp(s2 - s1 * s1 / n, min=0.0)  # n * window variance
    # Below this per-pixel variance the score is rounding noise (OpenCV
    # zeroes these too); in float32 the floor must stand above that noise.
    var_floor = n * (eps if dtype == torch.float64 else 1e-2)
    safe = win_var_n > var_floor
    denom = torch.sqrt(t_energy * win_var_n)
    scores = torch.where(safe, num / torch.where(safe, denom, torch.ones_like(denom)), 0.0)
    return torch.clamp(scores, -1.0, 1.0)


def match_template_ccoeff(
    frame: torch.Tensor, template: torch.Tensor, method: str = "auto"
) -> torch.Tensor:
    """Plain TM_CCOEFF (unnormalized correlation coefficient):
    cross-correlation of the frame with the zero-mean template -- the same
    numerator as the normed variant, without the variance normalization."""
    dtype = torch.promote_types(frame.dtype, torch.float32)
    t = template.to(dtype)
    return _xcorr(method, t.shape[0] * t.shape[1])(frame.to(dtype), t - t.mean())


def min_max_loc(scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cv2.minMaxLoc``'s max side: ``(max_val, (x, y))`` with row-major
    first-occurrence tie-breaking."""
    flat = scores.reshape(-1)
    idx = torch.argmax(flat)
    w = scores.shape[-1]
    return flat[idx], torch.stack([idx % w, idx // w])


def match_best(
    frame: torch.Tensor, template: torch.Tensor, method: str = "auto"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-match shortcut: ``(score, (x, y))`` like the reference's
    ``minMaxLoc(matchTemplate(...))`` pairs."""
    return min_max_loc(match_template_ccoeff_normed(frame, template, method))
