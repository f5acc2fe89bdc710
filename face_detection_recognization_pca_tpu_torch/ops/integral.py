"""Integral images and windowed moments (port of ``ops/integral.py``).

Window sums in O(1) per window from a 2-D prefix sum; every function is
batched over leading dims.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def integral_image(img: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Zero-padded integral image: ``S[i, j] = sum(img[:i, :j])``, of
    shape ``(..., H + 1, W + 1)`` (``cv2.integral``'s layout), in ``dtype``
    (default: the image's promoted to at least float32)."""
    dtype = dtype or torch.promote_types(img.dtype, torch.float32)
    s = torch.cumsum(torch.cumsum(img.to(dtype), dim=-2), dim=-1)
    return F.pad(s, (1, 0, 1, 0))


def window_sums(integral: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """Sum of every ``(wh, ww)`` window at the valid positions, from an
    ``(..., H + 1, W + 1)`` integral: ``(..., H - wh + 1, W - ww + 1)``."""
    wh, ww = window
    a = integral[..., wh:, ww:]
    b = integral[..., wh:, :-ww]
    c = integral[..., :-wh, ww:]
    d = integral[..., :-wh, :-ww]
    return a - b - c + d


def window_mean_var(
    img: torch.Tensor, window: Tuple[int, int], dtype: torch.dtype = torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-window mean and (population) variance via two integrals."""
    wh, ww = window
    n = wh * ww
    s1 = window_sums(integral_image(img, dtype), window)
    s2 = window_sums(integral_image(img.to(dtype) ** 2, dtype), window)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return mean, var
