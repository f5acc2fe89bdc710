"""Gallery cosine with zero-norm guard, and argmax-with-threshold
(port of ``ops/similarity.py``)."""

from __future__ import annotations

from typing import Tuple

import torch


def cosine_gallery(probes: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """``(B, k)`` probes against an ``(N, k)`` gallery -> ``(B, N)``
    cosines; a zero-norm probe or row scores 0."""
    dots = probes @ gallery.T
    denom = torch.linalg.vector_norm(probes, dim=-1, keepdim=True) * (
        torch.linalg.vector_norm(gallery, dim=-1, keepdim=True).T
    )
    safe = denom > 0
    return torch.where(safe, dots / torch.where(safe, denom, torch.ones_like(denom)), 0.0)


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
