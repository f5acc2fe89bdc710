"""Reference-compatible model artifact store.

Reads and writes both pickle generations of the reference:

* **v1 schema** (writer: reference ``useless/train.py:147-158``): dict of
  plain arrays -- ``eigenfaces (d, k)``, ``mean_face (d,)``,
  ``projected_data (n, k)``, ``eigenvalues (k,)``,
  ``training_filenames``, ``person_name``, ``version``, ``n_components``,
  ``face_dimensions``, ``training_timestamp``.

* **v2 schema** (writer: reference ``train-v4.py:210-226``): dict with
  live sklearn ``PCA``/``StandardScaler`` objects plus arrays
  ``face_features``, ``face_labels``, ``face_info``, ``person_id_map``,
  ``n_components``, ``mean_face``, ``eigenfaces (k, d)``, ``face_shape``,
  ``training_date``.  The shipped ``face_model.pkl`` keys the PCA object
  as ``pca_model`` instead of ``pca`` (written by a script version no
  longer in the reference repo) -- the loader accepts both.

Both load into one normalized :class:`EigenfacesArtifact`.  Unpickling
never requires sklearn: a class-substitution unpickler maps sklearn
classes onto the NumPy shims in :mod:`.sklearn_shim`.  Writers emit real
sklearn objects when sklearn is importable (so reference scripts can
load our models byte-compatibly) and shims otherwise.

This is the port's own copy of the JAX package's ``io/artifacts.py``, and
the two read each other's files.  The arrays are plain numpy either
way.  Where sklearn is absent a v2 pickle names the writer's shim
classes by module path: the loader here maps the JAX package's paths
onto its own shims without importing that package, and the JAX
package's loader resolves this package's paths by importing
:mod:`.sklearn_shim`, which needs numpy only.
"""

from __future__ import annotations

import dataclasses
import io as _io
import pickle
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np

from face_detection_recognization_pca_tpu_torch.io.sklearn_shim import (
    SKLEARN_CLASS_MAP,
    PCAShim,
    StandardScalerShim,
)


class _ShimUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        cls = SKLEARN_CLASS_MAP.get((module, name))
        if cls is not None:
            return cls
        if module.startswith("sklearn"):
            raise pickle.UnpicklingError(
                f"unsupported sklearn class in model pickle: {module}.{name}"
            )
        return super().find_class(module, name)


def _shim_loads(data: bytes) -> Any:
    return _ShimUnpickler(_io.BytesIO(data)).load()


@dataclasses.dataclass
class EigenfacesArtifact:
    """Normalized in-memory model, independent of on-disk generation.

    ``components`` is always row-major ``(k, d)``; v1's ``(d, k)``
    eigenfaces are transposed on load and back on save.
    """

    components: np.ndarray  # (k, d)
    mean_face: np.ndarray  # (d,) -- raw-pixel mean (v1: also projection mean)
    features: np.ndarray  # (n, k) projected gallery
    labels: np.ndarray  # (n,) int person ids (v1: all zeros)
    person_id_map: Dict[str, int]
    face_shape: tuple  # (h, w)
    n_components: int
    schema: str  # 'v1' | 'v2'
    # Scaler (v2 only; None => v1 center-only pipeline).
    scaler_mean: Optional[np.ndarray] = None
    scaler_scale: Optional[np.ndarray] = None
    # Projection mean: what gets subtracted before components^T.
    # v1: == mean_face. v2: sklearn PCA.mean_ (mean of the *scaled* data).
    projection_mean: Optional[np.ndarray] = None
    eigenvalues: Optional[np.ndarray] = None
    explained_variance_ratio: Optional[np.ndarray] = None
    person_name: Optional[str] = None
    version: Optional[str] = None
    training_date: Optional[str] = None
    face_info: Optional[List[dict]] = None
    training_filenames: Optional[List[str]] = None

    @property
    def names_by_id(self) -> Dict[int, str]:
        return {v: k for k, v in self.person_id_map.items()}


def load_model(path: str) -> EigenfacesArtifact:
    """Load either pickle generation into an :class:`EigenfacesArtifact`."""
    with open(path, "rb") as f:
        raw = _shim_loads(f.read())
    if not isinstance(raw, dict):
        raise ValueError(f"unrecognized model pickle at {path}")
    if "projected_data" in raw:  # v1
        eigenfaces = np.asarray(raw["eigenfaces"])  # (d, k)
        mean = np.asarray(raw["mean_face"])
        feats = np.asarray(raw["projected_data"])
        d = mean.shape[0]
        side = int(round(d ** 0.5))
        name = raw.get("person_name")
        return EigenfacesArtifact(
            components=eigenfaces.T.copy(),
            mean_face=mean,
            features=feats,
            labels=np.zeros(feats.shape[0], dtype=np.int64),
            person_id_map={name: 0} if name else {},
            face_shape=(side, side),
            n_components=int(raw.get("n_components", eigenfaces.shape[1])),
            schema="v1",
            projection_mean=mean,
            eigenvalues=np.asarray(raw["eigenvalues"]) if "eigenvalues" in raw else None,
            person_name=name,
            version=raw.get("version"),
            training_date=raw.get("training_timestamp"),
            training_filenames=raw.get("training_filenames"),
        )
    # v2: accept both 'pca' (train-v4.py:211) and 'pca_model' (shipped file).
    pca = raw.get("pca", raw.get("pca_model"))
    scaler = raw.get("scaler")
    if pca is None:
        raise ValueError(f"model pickle at {path} has no PCA object")
    components = np.asarray(raw.get("eigenfaces", pca.components_))
    face_shape = tuple(raw.get("face_shape", (64, 64)))
    feats = np.asarray(raw["face_features"])
    evr = getattr(pca, "explained_variance_ratio_", None)
    return EigenfacesArtifact(
        components=components,
        mean_face=np.asarray(raw["mean_face"]),
        features=feats,
        labels=np.asarray(raw["face_labels"]),
        person_id_map=dict(raw.get("person_id_map", {})),
        face_shape=face_shape,
        n_components=int(raw.get("n_components", components.shape[0])),
        schema="v2",
        scaler_mean=np.asarray(scaler.mean_) if scaler is not None else None,
        scaler_scale=np.asarray(scaler.scale_) if scaler is not None else None,
        projection_mean=np.asarray(pca.mean_),
        eigenvalues=np.asarray(getattr(pca, "explained_variance_", None))
        if getattr(pca, "explained_variance_", None) is not None
        else None,
        explained_variance_ratio=np.asarray(evr) if evr is not None else None,
        training_date=raw.get("training_date"),
        face_info=raw.get("face_info"),
    )


def make_sklearn_pair(
    components: np.ndarray,  # (k, d)
    projection_mean: np.ndarray,  # (d,)
    scaler_mean: np.ndarray,  # (d,)
    scaler_scale: np.ndarray,  # (d,)
    eigenvalues: Optional[np.ndarray] = None,
    explained_variance_ratio: Optional[np.ndarray] = None,
    n_samples: int = 0,
):
    """Fitted (PCA, StandardScaler) pair for embedding in pickles.

    Real sklearn estimators when sklearn is importable (so reference
    scripts can load our models byte-compatibly); NumPy shims otherwise.
    """
    try:
        from sklearn.decomposition import PCA  # type: ignore
        from sklearn.preprocessing import StandardScaler  # type: ignore

        k = components.shape[0]
        pca = PCA(n_components=k)
        pca.components_ = np.asarray(components)
        pca.mean_ = np.asarray(projection_mean)
        pca.n_components_ = k
        pca.n_features_in_ = components.shape[1]
        pca.n_samples_ = n_samples
        # transform() dereferences explained_variance_ unconditionally
        # (sklearn _BasePCA.transform); always populate it.
        pca.explained_variance_ = (
            np.asarray(eigenvalues)
            if eigenvalues is not None
            else np.zeros(k)
        )
        pca.singular_values_ = np.sqrt(
            np.maximum(pca.explained_variance_ * max(n_samples - 1, 1), 0.0)
        )
        if explained_variance_ratio is not None:
            pca.explained_variance_ratio_ = np.asarray(
                explained_variance_ratio
            )
        pca.noise_variance_ = 0.0
        pca.whiten = False

        scaler = StandardScaler()
        scaler.mean_ = np.asarray(scaler_mean)
        scaler.scale_ = np.asarray(scaler_scale)
        scaler.var_ = scaler.scale_ ** 2
        scaler.n_features_in_ = scaler.mean_.shape[0]
        scaler.n_samples_seen_ = n_samples
        scaler.with_mean = True
        scaler.with_std = True
        return pca, scaler
    except Exception:
        pca = PCAShim.from_arrays(
            components,
            projection_mean,
            explained_variance=eigenvalues,
            explained_variance_ratio=explained_variance_ratio,
            n_samples=n_samples,
        )
        scaler = StandardScalerShim.from_arrays(
            scaler_mean, scaler_scale, n_samples=n_samples
        )
        return pca, scaler


def _make_sklearn_objects(art: EigenfacesArtifact):
    return make_sklearn_pair(
        art.components,
        art.projection_mean,
        art.scaler_mean,
        art.scaler_scale,
        eigenvalues=art.eigenvalues,
        explained_variance_ratio=art.explained_variance_ratio,
        n_samples=art.features.shape[0],
    )


def save_model_v2(art: EigenfacesArtifact, path: str) -> None:
    """Write the v2 pickle schema (reference ``train-v4.py:210-226``)."""
    if art.scaler_mean is None or art.projection_mean is None:
        raise ValueError("v2 schema requires scaler + projection mean")
    pca, scaler = _make_sklearn_objects(art)
    model_data = {
        "pca": pca,
        "scaler": scaler,
        "face_features": np.asarray(art.features),
        "face_labels": np.asarray(art.labels),
        "face_info": art.face_info or [],
        "person_id_map": dict(art.person_id_map),
        "n_components": int(art.n_components),
        "mean_face": np.asarray(art.mean_face),
        "eigenfaces": np.asarray(art.components),
        "face_shape": tuple(art.face_shape),
        "training_date": art.training_date or datetime.now().isoformat(),
    }
    with open(path, "wb") as f:
        pickle.dump(model_data, f)


def save_model_v1(art: EigenfacesArtifact, path: str) -> None:
    """Write the v1 pickle schema (reference ``useless/train.py:147-158``)."""
    model_data = {
        "eigenfaces": np.asarray(art.components).T,  # (d, k)
        "mean_face": np.asarray(art.mean_face),
        "projected_data": np.asarray(art.features),
        "eigenvalues": np.asarray(art.eigenvalues)
        if art.eigenvalues is not None
        else np.zeros(art.n_components),
        "training_filenames": art.training_filenames or [],
        "person_name": art.person_name or "",
        "version": art.version or "",
        "training_timestamp": art.training_date or datetime.now().isoformat(),
        "n_components": int(art.n_components),
        "face_dimensions": int(np.asarray(art.mean_face).shape[0]),
    }
    with open(path, "wb") as f:
        pickle.dump(model_data, f)


def write_model_info_json(art: EigenfacesArtifact, path: str) -> None:
    """v2 model-info JSON (reference ``train-v4.py:182-196``)."""
    import json

    info = {
        "n_faces": int(art.features.shape[0]),
        "n_components": int(art.n_components),
        "face_shape": list(art.face_shape),
        "person_id_map": art.person_id_map,
        "explained_variance_ratio": float(
            np.sum(art.explained_variance_ratio)
        )
        if art.explained_variance_ratio is not None
        else None,
        "training_date": art.training_date or datetime.now().isoformat(),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(info, f, indent=2, ensure_ascii=False)
