"""The eigenfaces model as an ``nn.Module`` (port of ``models/eigenfaces.py``).

The model's tensors are buffers, so ``model.to(device)`` moves them all;
the scaler buffers are ``None`` for a v1 (snapshot, center-only) model.
Weights are carried over from and to the JAX package two ways:
:func:`from_params` and :func:`to_params` by host arrays keyed by the
field names of its ``EigenfacesModel``, and :func:`from_artifact` and
:func:`to_artifact` by the model files of :mod:`..io.artifacts`, which
both packages read and write.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from face_detection_recognization_pca_tpu_torch.io.artifacts import EigenfacesArtifact
from face_detection_recognization_pca_tpu_torch.linalg.pca import scaled_pca, snapshot_pca
from face_detection_recognization_pca_tpu_torch.linalg.standardize import (
    ScalerParams,
    scaler_fit,
    scaler_transform,
)
from face_detection_recognization_pca_tpu_torch.ops.preprocess import preprocess_crops
from face_detection_recognization_pca_tpu_torch.ops.similarity import (
    best_match,
    cosine_gallery,
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


def train_v2(
    images: torch.Tensor,
    labels: torch.Tensor,
    n_components: int = 50,
    face_shape: Tuple[int, int] = (64, 64),
) -> Tuple[EigenfacesModel, dict]:
    """v2 training: z-score, then sklearn-parity PCA, on ``(n, d)`` crops
    already resized to ``face_shape`` and flattened, with ``(n,)`` integer
    person ids.  Returns ``(model, aux)`` like :func:`train_v1`."""
    scaler = scaler_fit(images)
    res = scaled_pca(scaler_transform(images, scaler), n_components)
    model = EigenfacesModel(
        components=res.components,
        projection_mean=res.mean,
        mean_face=images.mean(dim=0),
        gallery=res.projected,
        labels=labels.to(torch.int32),
        scaler_mean=scaler.mean,
        scaler_scale=scaler.scale,
        face_shape=tuple(face_shape),
        schema="v2",
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


def extract_features(
    model: EigenfacesModel, crops: torch.Tensor, exact: bool = False
) -> torch.Tensor:
    """``(B, h, w)`` gray or ``(B, h, w, 3)`` BGR crops -> ``(B, k)``
    eigenspace features: resize to the model's face shape, flatten,
    scale and project, in the components' dtype."""
    h, w = model.face_shape
    flat = preprocess_crops(crops, (w, h), exact=exact, dtype=model.components.dtype)
    return project_vectors(model, flat)


def recognize(
    model: EigenfacesModel,
    crops: torch.Tensor,
    threshold: float = 0.7,
    exact: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop batch -> ``(person_ids, confidences)``: features, gallery
    cosine, first-maximum argmax, and id -1 below ``threshold``."""
    feats = extract_features(model, crops, exact=exact)
    return best_match(cosine_gallery(feats, model.gallery), model.labels, threshold)


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


def from_artifact(
    art: EigenfacesArtifact, dtype: torch.dtype, device: torch.device
) -> EigenfacesModel:
    """Load an :class:`..io.artifacts.EigenfacesArtifact` onto ``device``
    with float buffers in ``dtype`` (a v1 artifact's projection mean is
    its mean face)."""

    def tensor(value):
        return None if value is None else torch.from_numpy(np.asarray(value)).to(device, dtype)

    pmean = art.projection_mean if art.projection_mean is not None else art.mean_face
    return EigenfacesModel(
        components=tensor(art.components),
        projection_mean=tensor(pmean),
        mean_face=tensor(art.mean_face),
        gallery=tensor(art.features),
        labels=torch.from_numpy(np.asarray(art.labels).astype(np.int32)).to(device),
        scaler_mean=tensor(art.scaler_mean),
        scaler_scale=tensor(art.scaler_scale),
        face_shape=tuple(art.face_shape),
        schema=art.schema,
    )


def to_artifact(
    model: EigenfacesModel, aux: Optional[Mapping[str, torch.Tensor]] = None, **meta
) -> EigenfacesArtifact:
    """Model -> serializable artifact, the inverse of :func:`from_artifact`.
    ``aux`` is the trainer's (``eigenvalues``, ``explained_variance_ratio``);
    ``meta`` may give ``person_id_map``, ``person_name``, ``version``,
    ``training_date``, ``face_info`` and ``training_filenames``."""
    params = to_params(model)
    aux = {key: value.cpu().numpy() for key, value in (aux or {}).items()}
    return EigenfacesArtifact(
        components=params["components"],
        mean_face=params["mean_face"],
        features=params["gallery"],
        labels=params["labels"],
        person_id_map=meta.get("person_id_map", {}),
        face_shape=tuple(model.face_shape),
        n_components=model.n_components,
        schema=model.schema,
        scaler_mean=params["scaler_mean"],
        scaler_scale=params["scaler_scale"],
        projection_mean=params["projection_mean"],
        eigenvalues=aux.get("eigenvalues"),
        explained_variance_ratio=aux.get("explained_variance_ratio"),
        person_name=meta.get("person_name"),
        version=meta.get("version"),
        training_date=meta.get("training_date"),
        face_info=meta.get("face_info"),
        training_filenames=meta.get("training_filenames"),
    )
