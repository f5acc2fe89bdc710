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

import collections
import functools
from typing import Optional, Tuple

import numpy as np
import torch

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS  # 2048


@functools.lru_cache(maxsize=256)
def _fixed_point_coeffs(src: int, dst: int, step: Optional[float] = None):
    """Per output index, the pair of source indices and their fixed-point
    weights as OpenCV computes them: ``(s0, s1, w0, w1)`` numpy arrays,
    both indices clamped into the image.  ``step`` is the source step per
    output pixel, ``src / dst`` unless given (``1 / fx``).

    At a clamped border OpenCV keeps the split pair ``(2048 - r, r)`` of
    the unclamped fraction and points both indices at the border row, so
    in the vertical pass each term is truncated on its own.  That loses
    one step on about 0.1% of border pixels against a single 2048-weight
    term, and is reproduced here."""
    scale = src / dst if step is None else step  # double, like cv2
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
    return _resize_u8(img, int(dsize[0]), int(dsize[1]), None, None)


def _cv_round(v: float) -> int:
    # saturate_cast<int>(double): cvRound, half to even.
    return int(np.rint(v))


def resize_bilinear_u8_exact_scale(img: torch.Tensor, fx: float, fy: float) -> torch.Tensor:
    """``cv2.resize(img, None, fx=fx, fy=fy)`` (INTER_LINEAR) of uint8
    ``(..., H, W)`` gray images, bit for bit, on ``img``'s device.

    The output is ``saturate_cast<int>(W * fx)`` wide (half to even) and
    the source step is ``1 / fx``, as OpenCV takes it when no ``dsize`` is
    given.  A step of exactly 2 on both axes is OpenCV's ``INTER_AREA``
    fast path: 2 x 2 means ``(a + b + c + d + 2) >> 2``, and an output
    pixel whose block leaves the image averages the pixels inside it with
    round half to even."""
    sh, sw = img.shape[-2:]
    dw, dh = _cv_round(sw * fx), _cv_round(sh * fy)
    if (dw, dh) == (sw, sh):
        return img.clone()
    step_x, step_y = 1.0 / fx, 1.0 / fy
    if step_x == 2.0 and step_y == 2.0:
        return _area_half(img, dh, dw)
    return _resize_u8(img, dw, dh, step_x, step_y)


def _area_half(img: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """OpenCV's ``resizeAreaFast`` at 2 x 2 for uint8."""
    sh, sw = img.shape[-2:]
    x = img.to(torch.int32)
    fh, fw = min(dh, sh // 2), min(dw, sw // 2)
    out = torch.zeros((*img.shape[:-2], dh, dw), dtype=torch.int32, device=img.device)
    full = x[..., : 2 * fh, : 2 * fw]
    blocks = full[..., 0::2, 0::2] + full[..., 0::2, 1::2] + full[..., 1::2, 0::2] + full[..., 1::2, 1::2]
    out[..., :fh, :fw] = torch.bitwise_right_shift(blocks + 2, 2)
    if (fh, fw) != (dh, dw):
        # The blocks that leave the image: the mean of the pixels inside,
        # rounded half to even (saturate_cast<uchar> of a float).
        pad = torch.zeros((*img.shape[:-2], 2 * dh, 2 * dw), dtype=torch.int32, device=img.device)
        cnt = torch.zeros((2 * dh, 2 * dw), dtype=torch.int32, device=img.device)
        ph, pw = min(sh, 2 * dh), min(sw, 2 * dw)
        pad[..., :ph, :pw] = x[..., :ph, :pw]
        cnt[:ph, :pw] = 1
        s = pad[..., 0::2, 0::2] + pad[..., 0::2, 1::2] + pad[..., 1::2, 0::2] + pad[..., 1::2, 1::2]
        c = cnt[0::2, 0::2] + cnt[0::2, 1::2] + cnt[1::2, 0::2] + cnt[1::2, 1::2]
        edge = torch.round(s.to(torch.float32) / c.clamp_min(1).to(torch.float32)).to(torch.int32)
        edge = torch.where(c > 0, edge, 0)
        mask = torch.ones((dh, dw), dtype=torch.bool, device=img.device)
        mask[:fh, :fw] = False
        out = torch.where(mask, edge, out)
    return out.clamp(0, 255).to(torch.uint8)


def _resize_u8(
    img: torch.Tensor, dw: int, dh: int, step_x: Optional[float], step_y: Optional[float]
) -> torch.Tensor:
    sh, sw = img.shape[-2:]

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(img.device)

    sx, sx1, ax0, ax1 = (dev(a) for a in _fixed_point_coeffs(sw, dw, step_x))
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
        sy, sy1, by0, by1 = (dev(a) for a in _fixed_point_coeffs(sh, dh, step_y))
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


# (sh, sw, dh, dw, device, dtype) -> (Wy, Wx^T), the least recently used first.
_MATRIX_CACHE: "collections.OrderedDict[tuple, Tuple[torch.Tensor, torch.Tensor]]" = (
    collections.OrderedDict()
)
_MATRIX_CACHE_MAX_BYTES = 512 << 20


def _interp_matrices(sh: int, sw: int, dh: int, dw: int, device: torch.device, dtype: torch.dtype):
    """``(Wy (dh, sh), Wx^T (sw, dw))`` on ``device``, built and copied over
    once per geometry: at full-frame sizes the pair is tens of MB, and a
    copy from pageable memory on every call stalls the caller.  The Haar
    pyramid asks for one geometry per level (37 at 1080p, 160 MB), so the
    cache holds up to 512 MiB, two such frame sizes' worth; the least
    recently used pairs go first."""
    key = (sh, sw, dh, dw, device, dtype)
    pair = _MATRIX_CACHE.get(key)
    if pair is None:
        wy = _interp_matrix(sh, dh, np.float64)
        wxt = _interp_matrix(sw, dw, np.float64).T
        pair = (torch.from_numpy(wy).to(device, dtype), torch.from_numpy(wxt).to(device, dtype))
        _MATRIX_CACHE[key] = pair
        while len(_MATRIX_CACHE) > 1 and interp_cache_bytes() > _MATRIX_CACHE_MAX_BYTES:
            _MATRIX_CACHE.popitem(last=False)
    else:
        _MATRIX_CACHE.move_to_end(key)
    return pair


def interp_cache_bytes() -> int:
    """Bytes of the interpolation matrices the cache holds now."""
    return sum(t.numel() * t.element_size() for pair in _MATRIX_CACHE.values() for t in pair)


def resize_bilinear(
    img: torch.Tensor, dsize: Tuple[int, int], dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Float bilinear resize of ``(..., H, W)``; ``dsize`` is ``(width, height)``.

    The matrices are rounded from float64 to ``dtype`` once, as the JAX
    package's ``_interp_matrix(..., dtype)`` rounds them."""
    dw, dh = int(dsize[0]), int(dsize[1])
    wy, wxt = _interp_matrices(img.shape[-2], img.shape[-1], dh, dw, img.device, dtype)
    return wy @ img.to(dtype) @ wxt
