"""The eigenfaces model as an ``nn.Module`` (port of ``models/eigenfaces.py``).

The model's tensors are buffers, so ``model.to(device)`` moves them all;
the scaler buffers are ``None`` for a v1 (snapshot, center-only) model.
:func:`from_params` and :func:`to_params` carry weights over from and to
the JAX package: their keys are the field names of its
``EigenfacesModel``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from face_detection_recognization_pca_tpu_torch.linalg.pca import snapshot_pca
from face_detection_recognization_pca_tpu_torch.linalg.standardize import (
    ScalerParams,
    scaler_transform,
)

PARAM_NAMES = (
    "components",  # (k, d)
    "projection_mean",  # (d,)
    "mean_face",  # (d,) raw-pixel mean
    "gallery",  # (N, k) projected training features
    "labels",  # (N,) int32 person ids
    "scaler_mean",  # (d,) or None
    "scaler_scale",  # (d,) or None
)


class EigenfacesModel(nn.Module):
    """Eigenfaces model (v1 or v2 pipeline).

    v1 (snapshot, center-only): ``scaler_mean``/``scaler_scale`` are None
    and ``projection_mean == mean_face``.  v2 (scaled): the scaler
    z-scores the flattened crop first, then the projection subtracts
    ``projection_mean`` (mean of the scaled data).
    """

    def __init__(
        self,
        components: torch.Tensor,
        projection_mean: torch.Tensor,
        mean_face: torch.Tensor,
        gallery: torch.Tensor,
        labels: torch.Tensor,
        scaler_mean: Optional[torch.Tensor] = None,
        scaler_scale: Optional[torch.Tensor] = None,
        face_shape: Tuple[int, int] = (64, 64),
        schema: str = "v2",
    ):
        super().__init__()
        self.register_buffer("components", components)
        self.register_buffer("projection_mean", projection_mean)
        self.register_buffer("mean_face", mean_face)
        self.register_buffer("gallery", gallery)
        self.register_buffer("labels", labels.to(torch.int32))
        self.register_buffer("scaler_mean", scaler_mean)
        self.register_buffer("scaler_scale", scaler_scale)
        self.face_shape = tuple(int(v) for v in face_shape)
        self.schema = schema

    @property
    def n_components(self) -> int:
        return self.components.shape[0]


def train_v1(
    images: torch.Tensor, n_components: Optional[int] = 50
) -> Tuple[EigenfacesModel, dict]:
    """v1 snapshot-PCA training on ``(n, d)`` flattened square faces, on
    the device ``images`` lie on.  Returns ``(model, aux)``; aux carries
    the eigenvalues and explained-variance ratios."""
    res = snapshot_pca(images, n_components)
    n, d = images.shape
    side = int(round(d ** 0.5))
    model = EigenfacesModel(
        components=res.components,
        projection_mean=res.mean,
        mean_face=res.mean,
        gallery=res.projected,
        labels=torch.zeros(n, dtype=torch.int32, device=images.device),
        face_shape=(side, side),
        schema="v1",
    )
    aux = {
        "eigenvalues": res.eigenvalues,
        "explained_variance_ratio": res.explained_variance_ratio,
    }
    return model, aux


def project_vectors(model: EigenfacesModel, flat: torch.Tensor) -> torch.Tensor:
    """Already-flattened face vectors -> eigenspace (no resize)."""
    if model.scaler_mean is not None:
        flat = scaler_transform(flat, ScalerParams(model.scaler_mean, model.scaler_scale))
    return (flat - model.projection_mean) @ model.components.T


def from_params(
    params: Mapping[str, Optional[np.ndarray]],
    face_shape: Tuple[int, int],
    schema: str,
    device: torch.device,
) -> EigenfacesModel:
    """Build a model from host arrays keyed by :data:`PARAM_NAMES`
    (absent or ``None`` scaler entries mean a v1 model).  Float arrays
    keep their dtype, so a JAX model's arrays give the same outputs."""

    def tensor(name):
        value = params.get(name)
        if value is None:
            return None
        return torch.from_numpy(np.array(value)).to(device)

    return EigenfacesModel(
        **{name: tensor(name) for name in PARAM_NAMES},
        face_shape=face_shape,
        schema=schema,
    )


def to_params(model: EigenfacesModel) -> Dict[str, Optional[np.ndarray]]:
    """Host arrays keyed by :data:`PARAM_NAMES`; the inverse of
    :func:`from_params` together with ``model.face_shape`` and
    ``model.schema``."""
    return {
        name: None if getattr(model, name) is None else getattr(model, name).cpu().numpy()
        for name in PARAM_NAMES
    }
