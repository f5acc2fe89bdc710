"""Feature extractors for the enhanced ensemble: HOG, uniform LBP,
histogram equalization, sharpening, augmentations (port of
``ops/features.py``).

The reference's enhanced generation (``useless/train-enhanced.py``)
uses skimage's ``hog`` (9 orientations, 8x8 cells, 2x2 blocks, L2-Hys)
and ``local_binary_pattern`` (P=24, R=3, uniform) plus cv2 augmentation
(flip, +-5 deg rotation, brightness alpha/beta, 3x3 Gaussian blur) and
profile preprocessing (equalizeHist + sharpen kernel).  Every function
takes ``(..., h, w)`` tensors and computes on their device; an element
of a batch equals the single call.

The arithmetic is the JAX package's, step for step, so that the uint8
outputs and the LBP counts are equal to its results under x64:

* bilinear sampling (:func:`_sample_bilinear`) is
  ``jax.scipy.ndimage.map_coordinates(order=1, mode="constant")``: float64
  coordinates (the JAX package's coordinate grids are float64 under x64),
  weights ``upper = c - floor(c)`` and ``lower = 1 - upper``, per corner
  the product of the two weights times the float32 value (``cval`` 0
  outside), the four corners in ``itertools.product`` order summed left to
  right in float64, the sum rounded to float32.  LBP thresholds the
  samples (``sampled >= x``) and the rotation rounds them, so one ulp can
  flip a bit;
* HOG is float32 with floored ``%`` (``torch.remainder``) and floor
  division into the orientation bins, and its cell and block sums add
  their terms in the order XLA's reductions do;
* roundings are half to even (``jnp.round``), not OpenCV's half up.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# HOG
# ---------------------------------------------------------------------------


def hog_features(
    img: torch.Tensor,
    orientations: int = 9,
    cell: int = 8,
    block: int = 2,
    eps: float = 1e-5,
) -> torch.Tensor:
    """HOG descriptor (unsigned gradients, hard binning, L2-Hys blocks) of
    ``(..., h, w)`` images: ``(..., bh * bw * block * block * orientations)``
    float32.

    For a 64x64 input with default params: 8x8 cells -> 7x7 blocks of
    2x2x9 = (1764,) features, the same length skimage produces for the
    reference's call (``train-enhanced.py:86-93``)."""
    x = img.to(torch.float32)
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    # Central-difference gradients with zero edges (skimage convention).
    gy = torch.zeros_like(x)
    gy[..., 1:-1, :] = x[..., 2:, :] - x[..., :-2, :]
    gx = torch.zeros_like(x)
    gx[..., :, 1:-1] = x[..., :, 2:] - x[..., :, :-2]
    mag = _sqrt(gx * gx + gy * gy)
    # Unsigned orientation in [0, 180).
    ang = torch.remainder(torch.rad2deg(torch.atan2(gy, gx)), 180.0)
    bin_width = 180.0 / orientations
    bin_idx = torch.floor_divide(ang, bin_width).to(torch.int64).clamp(0, orientations - 1)

    ch, cw = h // cell, w // cell
    # Per-pixel one-hot into orientation bins, weighted by magnitude.
    weighted = torch.nn.functional.one_hot(bin_idx, orientations).to(torch.float32)
    weighted = (weighted * mag[..., None])[..., : ch * cell, : cw * cell, :].reshape(
        *lead, ch, cell, cw, cell, orientations
    )
    # Each cell's mean like skimage: its pixels summed row by row, left to
    # right, in float32.
    cells = _ordered_sum([weighted[..., :, i, :, j, :] for i in range(cell) for j in range(cell)])
    cells = cells / (cell * cell)  # (..., ch, cw, o)

    # Blocks with L2-Hys normalization.
    bh, bw = ch - block + 1, cw - block + 1
    out = []
    for by in range(block):
        for bx in range(block):
            out.append(cells[..., by : by + bh, bx : bx + bw, :])
    blocks = torch.stack(out, dim=-2).reshape(*lead, bh, bw, -1)
    blocks = blocks / _l2(blocks, eps)
    blocks = torch.minimum(blocks, torch.tensor(0.2, dtype=torch.float32, device=blocks.device))
    return (blocks / _l2(blocks, eps)).reshape(*lead, -1)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64): PyTorch's
    vectorised float32 ``sqrt`` on the CPU misses it by an ulp at times,
    XLA's does not."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _ordered_sum(terms) -> torch.Tensor:
    """The terms added left to right."""
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


def _xla_sum(terms) -> torch.Tensor:
    """The terms summed as XLA on the CPU sums a reduction over one axis:
    left to right up to 32 terms; beyond that, split into windows of 32
    after padding both ends equally with zeros to a multiple of 32, each
    window left to right, then the windows' sums the same way."""
    n = len(terms)
    if n <= 32:
        return _ordered_sum(terms)
    padded = -(-n // 32) * 32
    lo = (padded - n) // 2
    windows = [terms[max(0, w - lo) : max(0, w + 32 - lo)] for w in range(0, padded, 32)]
    return _xla_sum([_ordered_sum(t) for t in windows if t])


def _l2(blocks: torch.Tensor, eps: float) -> torch.Tensor:
    """``sqrt(sum(v * v) + eps^2)`` over the last axis."""
    sq = blocks * blocks
    return _sqrt(_xla_sum([sq[..., i : i + 1] for i in range(sq.shape[-1])]) + eps**2)


# ---------------------------------------------------------------------------
# Bilinear sampling (map_coordinates order 1, constant 0 outside)
# ---------------------------------------------------------------------------


def _sample_bilinear(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """float32 ``(..., h, w)`` images sampled at float64 ``(h', w')``
    coordinates, in ``map_coordinates``' arithmetic (module docstring):
    float32 ``(..., h', w')``."""
    h, w = x.shape[-2:]
    nodes = []
    for c, size in ((rows, h), (cols, w)):
        lower = torch.floor(c)
        upper_w = c - lower
        lower_w = 1 - upper_w
        idx = lower.to(torch.int64)
        nodes.append(((idx, lower_w), (idx + 1, upper_w)))
    flat = x.reshape(*x.shape[:-2], h * w)
    total = None
    for (ri, rw) in nodes[0]:
        for (ci, cw) in nodes[1]:
            valid = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w)
            at = (ri.clamp(0, h - 1) * w + ci.clamp(0, w - 1)).reshape(-1)
            value = flat[..., at].reshape(*x.shape[:-2], *ri.shape)
            value = torch.where(valid, value, torch.zeros((), dtype=x.dtype, device=x.device))
            term = (rw * cw) * value.to(torch.float64)
            total = term if total is None else total + term
    return total.to(torch.float32)


def _grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``arange`` row and column vectors, ``(h, 1)`` and ``(1, w)``."""
    rows = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return rows, cols


# ---------------------------------------------------------------------------
# Uniform LBP
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _lbp_offsets(n_points: int, radius: float) -> np.ndarray:
    ang = 2.0 * np.pi * np.arange(n_points) / n_points
    # skimage convention: (row, col) = (R sin, R cos), rows increasing
    # downward.
    return np.stack([radius * np.sin(ang), radius * np.cos(ang)], axis=0).astype(np.float32)


def lbp_uniform_hist(
    img: torch.Tensor, n_points: int = 24, radius: float = 3.0
) -> torch.Tensor:
    """Uniform LBP histogram of ``(..., h, w)`` images: ``(..., n_points +
    2)`` float32 bins, density-normalized (reference
    ``train-enhanced.py:96-115``).

    Uniform coding: patterns with <= 2 circular 0/1 transitions map to
    their popcount (0..P); all others to bin P+1.  Each sampling
    coordinate is the float32 sum ``row + offset``, taken on in float64."""
    x = img.to(torch.float32)
    h, w = x.shape[-2:]
    offs = _lbp_offsets(n_points, radius)
    rows, cols = _grid(h, w, x.device)
    bits = []
    for p in range(n_points):
        ry, rx = float(offs[0, p]), float(offs[1, p])
        cy = (rows + ry).to(torch.float64).expand(h, w)
        cx = (cols + rx).to(torch.float64).expand(h, w)
        bits.append((_sample_bilinear(x, cy, cx) >= x).to(torch.int32))
    bits = torch.stack(bits, dim=-1)  # (..., h, w, P)

    transitions = torch.sum(torch.abs(bits - torch.roll(bits, 1, dims=-1)), dim=-1)
    popcount = torch.sum(bits, dim=-1)
    code = torch.where(transitions <= 2, popcount, n_points + 1)
    nbins = n_points + 2
    hist = torch.nn.functional.one_hot(code.reshape(*x.shape[:-2], -1), nbins)
    return hist.sum(dim=-2).to(torch.float32) / (h * w)


# ---------------------------------------------------------------------------
# Preprocessing / augmentation (cv2 semantics)
# ---------------------------------------------------------------------------


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, saturate to uint8."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def equalize_hist_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.equalizeHist of uint8 ``(..., h, w)`` images: a LUT per image
    from the cumulative histogram excluding leading zeros, the scaling in
    float32 rounded half to even (the JAX package's rounding, which
    differs from OpenCV's by at most one level)."""
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    x = img.reshape(-1, h * w).to(torch.int64)
    hist = torch.zeros((x.shape[0], 256), dtype=torch.float32, device=img.device)
    hist.scatter_add_(1, x, torch.ones_like(x, dtype=torch.float32))
    cdf = torch.cumsum(hist, dim=1)
    total = cdf[:, -1:]
    # First nonzero histogram value's cdf (cv2 skips it in scaling).
    cdf_min = torch.where(hist > 0, cdf, torch.inf).min(dim=1, keepdim=True).values
    denom = torch.clamp(total - cdf_min, min=1.0)
    lut = _round_u8((cdf - cdf_min) / denom * 255.0)
    return torch.gather(lut, 1, x).reshape(*lead, h, w)


def _pad_reflect(x: torch.Tensor, top_bottom: bool = True, left_right: bool = True) -> torch.Tensor:
    """Pad the last two dims by one with numpy's ``reflect`` (OpenCV's
    reflect101): the edge row or column is not repeated."""
    if top_bottom:
        x = torch.cat([x[..., 1:2, :], x, x[..., -2:-1, :]], dim=-2)
    if left_right:
        x = torch.cat([x[..., :, 1:2], x, x[..., :, -2:-1]], dim=-1)
    return x


def sharpen_u8(img: torch.Tensor) -> torch.Tensor:
    """3x3 sharpen kernel [[-1..],[-1,9,-1],..] with saturation, matching
    ``cv2.filter2D`` + clip of the reference (border: reflect101)."""
    x = img.to(torch.float32)
    h, w = x.shape[-2:]
    p = _pad_reflect(x)
    out = 9.0 * x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out = out - p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    return _round_u8(out)


def convert_scale_abs(img: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """cv2.convertScaleAbs: |alpha*x + beta| in float32, saturated to uint8."""
    return _round_u8(torch.abs(img.to(torch.float32) * alpha + beta))


def gaussian_blur3_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur(img, (3,3), 0): separable [1,2,1]/4 kernel."""
    x = img.to(torch.float32)
    p = _pad_reflect(x, top_bottom=False)
    hsum = 0.25 * (p[..., :, :-2] + 2 * p[..., :, 1:-1] + p[..., :, 2:])
    p2 = _pad_reflect(hsum, left_right=False)
    out = 0.25 * (p2[..., :-2, :] + 2 * p2[..., 1:-1, :] + p2[..., 2:, :])
    return _round_u8(out)


def rotate_u8(img: torch.Tensor, degrees: float) -> torch.Tensor:
    """cv2.warpAffine with getRotationMatrix2D(center, angle, 1.0):
    bilinear, zero border, the source coordinates in float64."""
    h, w = img.shape[-2:]
    cy, cx = (h - 1) * 0.0 + h // 2, w // 2  # cv2 integer-center convention
    rad = math.radians(degrees)
    ca, sa = math.cos(rad), math.sin(rad)
    rows, cols = _grid(h, w, img.device)
    rows = rows.to(torch.float64).expand(h, w)
    cols = cols.to(torch.float64).expand(h, w)
    # Inverse map: source = R^-1 (dst - c) + c ; R(angle) in cv2 rotates
    # counter-clockwise for positive angle in image coords.
    sx = ca * (cols - cx) - sa * (rows - cy) + cx
    sy = sa * (cols - cx) + ca * (rows - cy) + cy
    return _round_u8(_sample_bilinear(img.to(torch.float32), sy, sx))


def augment_face(img: torch.Tensor) -> torch.Tensor:
    """The reference's 7-variant augmentation set
    (``train-enhanced.py:117-151``): original, horizontal flip, +-5 degree
    rotations, brightness up/down, 3x3 Gaussian blur.

    ``(..., h, w)`` -> ``(..., 7, h, w)`` uint8."""
    img = img.to(torch.uint8)
    return torch.stack(
        [
            img,
            torch.flip(img, dims=(-1,)),
            rotate_u8(img, -5.0),
            rotate_u8(img, 5.0),
            convert_scale_abs(img, 1.2, 10.0),
            convert_scale_abs(img, 0.8, -10.0),
            gaussian_blur3_u8(img),
        ],
        dim=-3,
    )
