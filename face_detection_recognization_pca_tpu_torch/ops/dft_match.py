"""Circular correlation as dense DFT matmuls (port of ``ops/dft_match.py``).

    F   = D W D^T          (D = C - iS, real W -> 6 real matmuls)
    Y   = F . conj(Kf)     (elementwise complex, precomputed kernel DFT)
    out = Re(E Y E^T)/N^2  (E = C + iS, truncated to the valid rows and
                            columns -> 6 more matmuls)

The cos/sin matrices and the kernel spectrum are built in numpy exactly
as the JAX package builds them (float64 angles cast to float32,
``np.fft.fft2`` in float64); the products are plain ``torch.matmul``.
Whether cuFFT beats this form on the GPU is still to be measured.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch


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
    its constants on ``device``.

    Exact when ``kernel_side + out - 1 <= n`` (alias-free).
    """
    kh, kw = kernel.shape
    if kh + out - 1 > n or kw + out - 1 > n:
        raise ValueError("alias-free condition violated: kernel + out > n")
    kpad = np.zeros((n, n), np.float64)
    kpad[:kh, :kw] = np.asarray(kernel, np.float64)
    kf = np.fft.fft2(kpad)

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
