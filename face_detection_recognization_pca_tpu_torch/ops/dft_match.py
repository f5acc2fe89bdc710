"""Circular correlation as dense DFT matmuls (port of ``ops/dft_match.py``).

    F   = D W D^T          (D = C - iS, real W -> 6 real matmuls)
    Y   = F . conj(Kf)     (elementwise complex, precomputed kernel DFT)
    out = Re(E Y E^T)/N^2  (E = C + iS, truncated to the valid rows and
                            columns -> 6 more matmuls)

The cos/sin matrices and the kernel spectrum are built in numpy exactly
as the JAX package builds them (float64 angles cast to float32,
``np.fft.fft2`` in float64); the products are plain ``torch.matmul``.
On the card the tracker's numerator is the FFT of
:mod:`.ncc_locate`'s kernel; this form is its plain route.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.device import exact_float32, resolve_device


@functools.lru_cache(maxsize=32)
def _dft_mats_np(n: int, out: int):
    k = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, k) / n
    c = np.cos(ang).astype(np.float32)
    s = np.sin(ang).astype(np.float32)
    return c, s, np.ascontiguousarray(c[:out]), np.ascontiguousarray(s[:out])


def make_circular_correlator(
    kernel: np.ndarray, n: int, out: int, device: Optional[torch.device] = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``fn(W (B, n, n)) -> (B, out, out)`` computing the valid
    circular correlation of each slice with ``kernel`` (h, w <= n), with
    its constants on ``device`` (``None``: the CUDA device).

    Exact when ``kernel_side + out - 1 <= n`` (alias-free).
    """
    kh, kw = kernel.shape
    if kh + out - 1 > n or kw + out - 1 > n:
        raise ValueError("alias-free condition violated: kernel + out > n")
    kpad = np.zeros((n, n), np.float64)
    kpad[:kh, :kw] = np.asarray(kernel, np.float64)
    kf = np.fft.fft2(kpad)
    device = resolve_device(device)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    kr = dev(np.real(kf).astype(np.float32))
    ki = dev(np.imag(kf).astype(np.float32))
    c, s, c_out, s_out = (dev(a) for a in _dft_mats_np(n, out))
    inv_n2 = 1.0 / (n * n)

    def corr(w: torch.Tensor) -> torch.Tensor:
        w = w.to(torch.float32)
        # Forward: F = (C - iS) W (C - iS)^T.
        p = c @ w
        q = s @ w
        fr = p @ c.T - q @ s.T
        fi = -(p @ s.T + q @ c.T)
        # Multiply by conj(Kf):  (fr + i fi)(kr - i ki).
        yr = fr * kr + fi * ki
        yi = fi * kr - fr * ki
        # Inverse (truncated): Re((C + iS) Y (C + iS)^T) / n^2.
        lr = c_out @ yr - s_out @ yi
        li = c_out @ yi + s_out @ yr
        return (lr @ c_out.T - li @ s_out.T) * inv_n2

    return corr


def dft_correlate_valid(
    frames: torch.Tensor,  # (B, H, W) real
    kernels: torch.Tensor,  # (T, th, tw) real, th <= H, tw <= W
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Valid 2-D cross-correlation of a frame batch with T kernels as
    dense DFT matmuls: ``(B, T, out_h, out_w)``.

    Circular correlation at the frame's own size is alias-free for all
    valid shifts (``out_h <= H - th + 1`` rows never see wraparound), so
    nothing is padded.  This is the full-frame form of
    :func:`make_circular_correlator`; the kernel spectra are computed on
    the frames' device with the same matrices, because a template bank is
    data, not a constant.  The template detector of this package takes
    the ``rfft2`` route instead (:mod:`..detect.template`); this function
    is kept as the same operation in matmuls, and runs them in full
    float32."""
    f = frames.to(torch.float32)
    b, h, w = f.shape
    t, th, tw = kernels.shape
    assert out_h <= h - th + 1 and out_w <= w - tw + 1

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(f.device)

    ch, sh, ch_o, sh_o = (dev(a) for a in _dft_mats_np(h, out_h))
    cw, sw, cw_o, sw_o = (dev(a) for a in _dft_mats_np(w, out_w))
    kpad = torch.zeros((t, h, w), dtype=torch.float32, device=f.device)
    kpad[:, :th, :tw] = kernels.to(torch.float32)

    def fwd(x):  # real (N, h, w) -> (Fr, Fi) under D = C - iS per axis
        p = ch @ x
        q = sh @ x
        return p @ cw.T - q @ sw.T, -(p @ sw.T + q @ cw.T)

    with exact_float32():
        fr, fi = fwd(f)  # (B, h, w)
        kr, ki = fwd(kpad)  # (T, h, w)
        # Y = F . conj(K) over the (B, T) outer product.
        yr = (fr[:, None] * kr[None] + fi[:, None] * ki[None]).reshape(b * t, h, w)
        yi = (fi[:, None] * kr[None] - fr[:, None] * ki[None]).reshape(b * t, h, w)
        # Inverse truncated to the valid rows and columns:
        # Re((C + iS) Y (C + iS)^T) / (h w).
        lr = ch_o @ yr - sh_o @ yi
        li = ch_o @ yi + sh_o @ yr
        out = lr @ cw_o.T - li @ sw_o.T
    return out.reshape(b, t, out_h, out_w) / (h * w)
