"""Color conversion with OpenCV's numbers (port of ``ops/color.py``).

:func:`bgr_to_gray_exact` is OpenCV's 8-bit fixed-point BT.601 path
(``cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)``), bit for bit; the float
variants are within one uint8 step of it.
"""

from __future__ import annotations

import torch

# OpenCV's fixed-point BT.601 coefficients, scaled by 2**15 (they sum to
# exactly 32768), with round-half-up on the final shift.
_YUV_SHIFT = 15
_R2Y = 9798
_G2Y = 19235
_B2Y = 3735


def bgr_to_gray_exact(bgr: torch.Tensor) -> torch.Tensor:
    """uint8 ``(..., H, W, 3)`` BGR -> uint8 ``(..., H, W)`` gray, equal to
    ``cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)``."""
    x = bgr.to(torch.int32)
    acc = _B2Y * x[..., 0] + _G2Y * x[..., 1] + _R2Y * x[..., 2] + (1 << (_YUV_SHIFT - 1))
    return (acc >> _YUV_SHIFT).to(torch.uint8)


def bgr_to_gray(bgr: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Float BT.601 BGR -> gray, within one uint8 step of OpenCV."""
    x = bgr.to(dtype)
    return 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]


def rgb_to_gray(rgb: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Float BT.601 RGB -> gray (for frame sources other than OpenCV)."""
    x = rgb.to(dtype)
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
