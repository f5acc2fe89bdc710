"""Float bilinear resize with OpenCV geometry (port of ``ops/resize.py``).

Half-pixel centers with edge clamping, expressed as two interpolation
matmuls ``Wy @ img @ Wx^T``.  The matrices are built in numpy exactly as
the JAX package builds them, so the fold in :mod:`.fused_match` is the
same arithmetic in both packages.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _interp_matrix(src: int, dst: int, dtype) -> np.ndarray:
    """Dense (dst, src) bilinear interpolation matrix, half-pixel centers."""
    scale = src / dst
    d = np.arange(dst, dtype=np.float64)
    f = (d + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    f = np.where(s < 0, 0.0, f)
    s = np.maximum(s, 0)
    f = np.where(s >= src - 1, 0.0, f)
    s = np.minimum(s, src - 1)
    s1 = np.minimum(s + 1, src - 1)
    m = np.zeros((dst, src), dtype=np.float64)
    m[np.arange(dst), s] += 1.0 - f
    m[np.arange(dst), s1] += f
    return m.astype(dtype)


@functools.lru_cache(maxsize=256)
def _interp_matrices(sh: int, sw: int, dh: int, dw: int):
    return _interp_matrix(sh, dh, np.float64), _interp_matrix(sw, dw, np.float64).T


def resize_bilinear(
    img: torch.Tensor, dsize: Tuple[int, int], dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Float bilinear resize of ``(..., H, W)``; ``dsize`` is ``(width, height)``.

    The matrices are rounded from float64 to ``dtype`` once, as the JAX
    package's ``_interp_matrix(..., dtype)`` rounds them."""
    dw, dh = int(dsize[0]), int(dsize[1])
    wy, wxt = _interp_matrices(img.shape[-2], img.shape[-1], dh, dw)
    wy = torch.from_numpy(wy).to(img.device, dtype)
    wxt = torch.from_numpy(wxt).to(img.device, dtype)
    return wy @ img.to(dtype) @ wxt
