"""Bilinear resize with OpenCV geometry (port of ``ops/resize.py``).

Half-pixel centers with edge clamping, in two forms:

* :func:`resize_bilinear_u8_exact`: ``cv2.resize`` of a uint8 image bit
  for bit.  OpenCV's 8-bit bilinear is fixed point: coefficients rounded
  to 1/2048, int32 sums, a final shift by 22 with round-half-up.  This is
  the same integer arithmetic on int32 tensors.
* :func:`resize_bilinear`: a float resize as two interpolation matmuls
  ``Wy @ img @ Wx^T``, within one uint8 step of the exact one.  The
  matrices are built in numpy exactly as the JAX package builds them, so
  the fold in :mod:`.fused_match` is the same arithmetic in both packages.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS  # 2048


@functools.lru_cache(maxsize=256)
def _fixed_point_coeffs(src: int, dst: int):
    """Per output index, the pair of source indices and their fixed-point
    weights as OpenCV computes them: ``(s0, s1, w0, w1)`` numpy arrays,
    both indices clamped into the image.

    At a clamped border OpenCV keeps the split pair ``(2048 - r, r)`` of
    the unclamped fraction and points both indices at the border row, so
    in the vertical pass each term is truncated on its own.  That loses
    one step on about 0.1% of border pixels against a single 2048-weight
    term, and is reproduced here."""
    scale = src / dst  # double, like cv2
    d = np.arange(dst, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s
    s0 = np.clip(s, 0, src - 1)
    s1 = np.clip(s + 1, 0, src - 1)
    # cvRound is round-half-to-even on the float32 product, and the two
    # coefficients are rounded independently.
    w1 = np.rint((f * _COEF_SCALE).astype(np.float32)).astype(np.int32)
    w0 = np.rint(((1.0 - f) * _COEF_SCALE).astype(np.float32)).astype(np.int32)
    return s0, s1, w0, w1


def resize_bilinear_u8_exact(img: torch.Tensor, dsize: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img, dsize)`` (INTER_LINEAR) of uint8 ``(..., H, W)``
    gray images, bit for bit, on the device ``img`` lies on; ``dsize`` is
    ``(width, height)``.  Returns uint8 ``(..., height, width)``."""
    dw, dh = int(dsize[0]), int(dsize[1])
    sh, sw = img.shape[-2:]

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(img.device)

    sx, sx1, ax0, ax1 = (dev(a) for a in _fixed_point_coeffs(sw, dw))
    x = img.to(torch.int32)
    # Horizontal pass: a0 * p0 + a1 * p1 <= 2049 * 255 in int32.  Every
    # value below is non-negative, so the arithmetic shifts truncate.
    rows = x[..., :, sx] * ax0 + x[..., :, sx1] * ax1
    shift = torch.bitwise_right_shift
    if dh == sh:
        # A pure-horizontal resize: OpenCV casts the rows with full
        # 11-bit rounding.
        acc = shift(rows + (1 << (_COEF_BITS - 1)), _COEF_BITS)
    else:
        # Vertical pass as OpenCV's int16 mulhi SIMD does it: the rows are
        # shifted by 4 first, each b * r product is truncated at >> 16,
        # and the last 2 bits round half-up.
        sy, sy1, by0, by1 = (dev(a) for a in _fixed_point_coeffs(sh, dh))
        r0 = shift(rows[..., sy, :], 4)
        r1 = shift(rows[..., sy1, :], 4)
        m = shift(by0[:, None] * r0, 16) + shift(by1[:, None] * r1, 16)
        acc = shift(m + 2, 2)
    return acc.clamp(0, 255).to(torch.uint8)


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


@functools.lru_cache(maxsize=64)
def _interp_matrices(sh: int, sw: int, dh: int, dw: int, device: torch.device, dtype: torch.dtype):
    """``(Wy (dh, sh), Wx^T (sw, dw))`` on ``device``, built and copied over
    once per geometry: at full-frame sizes the pair is tens of MB, and a
    copy from pageable memory on every call stalls the caller."""
    wy = _interp_matrix(sh, dh, np.float64)
    wxt = _interp_matrix(sw, dw, np.float64).T
    return torch.from_numpy(wy).to(device, dtype), torch.from_numpy(wxt).to(device, dtype)


def resize_bilinear(
    img: torch.Tensor, dsize: Tuple[int, int], dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Float bilinear resize of ``(..., H, W)``; ``dsize`` is ``(width, height)``.

    The matrices are rounded from float64 to ``dtype`` once, as the JAX
    package's ``_interp_matrix(..., dtype)`` rounds them."""
    dw, dh = int(dsize[0]), int(dsize[1])
    wy, wxt = _interp_matrices(img.shape[-2], img.shape[-1], dh, dw, img.device, dtype)
    return wy @ img.to(dtype) @ wxt
