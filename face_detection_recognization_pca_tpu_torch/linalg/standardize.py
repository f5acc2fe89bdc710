"""StandardScaler semantics on tensors (port of ``linalg/standardize.py``).

Per-feature mean and population std (ddof=0), exact-zero stds replaced
by 1, moments accumulated in at least float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ScalerParams(NamedTuple):
    mean: torch.Tensor  # (d,)
    scale: torch.Tensor  # (d,) -- std with zero -> 1 guard


def scaler_fit(x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> ScalerParams:
    """Fit mean/scale over axis 0. ``x``: (n, d)."""
    dtype = dtype or x.dtype
    xw = x.to(torch.promote_types(dtype, torch.float32))
    mean = xw.mean(dim=0)
    # Two-pass variance: E[x^2]-E[x]^2 loses ~3 digits at pixel scale.
    centered = xw - mean
    std = (centered * centered).mean(dim=0).sqrt()
    scale = torch.where(std == 0.0, torch.ones_like(std), std)
    return ScalerParams(mean.to(dtype), scale.to(dtype))


def scaler_transform(x: torch.Tensor, params: ScalerParams) -> torch.Tensor:
    return (x - params.mean) / params.scale
