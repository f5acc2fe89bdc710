"""Cosine with zero-norm guard, all-pairs gallery cosine and L2, and
argmax-with-threshold (port of ``ops/similarity.py``)."""

from __future__ import annotations

from typing import Tuple

import torch


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Cosine similarity along the last axis; 0 where the product of the
    norms is not above ``eps``."""
    dot = (a * b).sum(dim=-1)
    denom = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)
    safe = denom > eps
    return torch.where(safe, dot / torch.where(safe, denom, torch.ones_like(denom)), 0.0)


def cosine_gallery(probes: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """``(B, k)`` probes against an ``(N, k)`` gallery -> ``(B, N)``
    cosines; a zero-norm probe or row scores 0."""
    dots = probes @ gallery.T
    denom = torch.linalg.vector_norm(probes, dim=-1, keepdim=True) * (
        torch.linalg.vector_norm(gallery, dim=-1, keepdim=True).T
    )
    safe = denom > 0
    return torch.where(safe, dots / torch.where(safe, denom, torch.ones_like(denom)), 0.0)


def euclidean_gallery(probes: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """``(B, N)`` L2 distances by ``|a|^2 - 2ab + |b|^2``, clipped at 0
    before the root."""
    p2 = (probes * probes).sum(dim=-1, keepdim=True)
    g2 = (gallery * gallery).sum(dim=-1, keepdim=True).T
    return torch.sqrt(torch.clamp(p2 - 2.0 * (probes @ gallery.T) + g2, min=0.0))


def best_match(
    scores: torch.Tensor, labels: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best gallery row per probe -> ``(person_ids, confidences)``.

    The first maximum wins ties, like ``np.argmax``; a best score below
    ``threshold`` gives person id -1 ("unknown") but still reports the
    score."""
    idx = torch.argmax(scores, dim=-1)
    conf = torch.gather(scores, -1, idx[..., None])[..., 0]
    ids = torch.where(conf >= threshold, labels[idx], -1)
    return ids, conf
