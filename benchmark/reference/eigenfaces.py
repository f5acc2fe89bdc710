"""Eigenfaces from their definitions: training (snapshot PCA of the v1
models, z-score + sklearn-style PCA of the v2 models), face vectors (gray,
bilinear resize with half-pixel centres, flatten) and cosine matching
against the projected training images."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .numerics import Arith


class Model(NamedTuple):
    """A model as the reference holds it: ``scale`` is None for v1."""

    shift: torch.Tensor  # (d,) subtracted first (v1: the mean image; v2: the scaler's mean)
    scale: Optional[torch.Tensor]  # (d,) the scaler's std (v2)
    center: Optional[torch.Tensor]  # (d,) mean of the scaled images (v2)
    components: torch.Tensor  # (k, d) orthonormal rows
    gallery: torch.Tensor  # (n, k) the training images projected


def _eig_top(gram: torch.Tensor, k: int) -> torch.Tensor:
    values, vectors = torch.linalg.eigh(gram)
    return vectors[:, torch.argsort(values, descending=True)[:k]]


def snapshot_pca(images: torch.Tensor, k: int, ar: Arith) -> Model:
    """v1: the top ``k`` eigenvectors of the centred images' covariance, by
    the Gram matrix when there are fewer images than pixels."""
    x = images.to(ar.single)
    mean = x.mean(dim=0)
    xc = x - mean
    vectors = _eig_top(ar.mm(xc, xc.T).to(ar.single) / (x.shape[0] - 1), k)
    comps = ar.mm(xc.T, vectors).to(ar.single)
    comps = (comps / torch.linalg.vector_norm(comps, dim=0)).T.contiguous()
    return Model(mean, None, None, comps, ar.mm(xc, comps.T).to(ar.single))


def scaled_pca(images: torch.Tensor, k: int, ar: Arith) -> Model:
    """v2: per-pixel z-score (population std, 0 taken as 1), then the top
    ``k`` right singular vectors of the centred scaled images."""
    x = images.to(ar.single)
    mean = x.mean(dim=0)
    std = torch.sqrt(((x - mean) ** 2).mean(dim=0))
    std = torch.where(std == 0, torch.ones_like(std), std)
    z = (x - mean) / std
    center = z.mean(dim=0)
    zc = z - center
    vectors = _eig_top(ar.mm(zc, zc.T).to(ar.single), min(k, x.shape[0] - 1))
    comps = ar.mm(zc.T, vectors).to(ar.single)
    comps = (comps / torch.linalg.vector_norm(comps, dim=0)).T.contiguous()
    return Model(mean, std, center, comps, ar.mm(zc, comps.T).to(ar.single))


def features(model: Model, vectors: torch.Tensor, ar: Arith) -> torch.Tensor:
    x = vectors.to(ar.single) - model.shift
    if model.scale is not None:
        x = x / model.scale - model.center
    return ar.mm(x, model.components.T).to(ar.single)


def cosines(model: Model, vectors: torch.Tensor, ar: Arith) -> torch.Tensor:
    """``(B, n)`` cosines of the face vectors with every gallery row; 0
    where either norm is 0."""
    f = features(model, vectors, ar)
    g = model.gallery
    dots = ar.mm(f, g.T).to(ar.single)
    denom = torch.linalg.vector_norm(f, dim=1)[:, None] * torch.linalg.vector_norm(g, dim=1)[None]
    return torch.where(denom > 0, dots / torch.where(denom > 0, denom, 1.0), 0.0)


def interp_matrix(src: int, dst: int) -> np.ndarray:
    """``(dst, src)`` float64 bilinear weights, half-pixel centres, the taps
    clamped into the image at both ends."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    lo = np.floor(pos)
    frac = pos - lo
    lo = lo.astype(np.int64)
    out = np.zeros((dst, src))
    for tap, weight in ((lo, 1.0 - frac), (lo + 1, frac)):
        np.add.at(out, (np.arange(dst), np.clip(tap, 0, src - 1)), weight)
    return out


def resize(images: torch.Tensor, size_hw: Tuple[int, int], ar: Arith) -> torch.Tensor:
    """Bilinear resize of ``(..., H, W)`` to ``size_hw``, a float32 part."""
    h, w = images.shape[-2:]
    wy = torch.from_numpy(interp_matrix(h, size_hw[0])).to(images.device)
    wx = torch.from_numpy(interp_matrix(w, size_hw[1])).to(images.device)
    return ar.mm(ar.mm(wy, images).to(ar.single), wx.T).to(ar.single)


def gray(bgr: torch.Tensor, ar: Arith) -> torch.Tensor:
    """BT.601 luma of ``(..., 3)`` BGR as floats."""
    x = bgr.to(ar.single)
    return 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]


def face_vectors(crops, face_hw: Tuple[int, int], ar: Arith, device) -> torch.Tensor:
    """uint8 BGR crops of any sizes -> ``(n, h * w)`` face vectors."""
    rows = []
    for crop in crops:
        g = gray(torch.from_numpy(np.ascontiguousarray(crop)).to(device), ar)
        rows.append(resize(g, face_hw, ar).reshape(-1))
    return torch.stack(rows)
