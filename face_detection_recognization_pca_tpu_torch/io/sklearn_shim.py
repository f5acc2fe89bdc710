"""Pure-NumPy stand-ins for the sklearn estimators embedded in pickles.

The reference's v2+ model pickles contain live
``sklearn.decomposition._pca.PCA`` and
``sklearn.preprocessing._data.StandardScaler`` objects
(reference ``train-v4.py:210-226``).  Loading them normally requires
sklearn; these shims reproduce exactly the attributes and ``transform``
math the scan scripts use (``scan-template-v4.py:266-268``), so the
framework can unpickle and serve reference models with NumPy alone.

The class-substitution unpickler in :mod:`.artifacts` maps the sklearn
module paths onto these classes; sklearn pickles restore state via
``__dict__`` update, which plain Python classes already support.

This is the port's own copy of the JAX package's ``io/sklearn_shim.py``.
A pickle that the JAX package wrote without sklearn names that
package's shim classes by module path; :data:`SKLEARN_CLASS_MAP` maps
those paths onto the classes here too, by name, so such a pickle loads
without importing the JAX package.
"""

from __future__ import annotations

import numpy as np


class PCAShim:
    """Attribute/transform-compatible stand-in for fitted ``sklearn...PCA``."""

    # Attributes populated by unpickling: components_, mean_, n_components_,
    # explained_variance_, explained_variance_ratio_, singular_values_,
    # whiten, n_samples_, noise_variance_ ...

    def __setstate__(self, state):
        self.__dict__.update(state)

    def transform(self, x):
        x = np.asarray(x)
        xt = x - self.mean_
        out = xt @ self.components_.T
        if getattr(self, "whiten", False):
            out /= np.sqrt(self.explained_variance_)
        return out

    def inverse_transform(self, x):
        x = np.asarray(x)
        if getattr(self, "whiten", False):
            x = x * np.sqrt(self.explained_variance_)
        return x @ self.components_ + self.mean_

    @classmethod
    def from_arrays(cls, components, mean, explained_variance=None,
                    explained_variance_ratio=None, singular_values=None,
                    n_samples=None, whiten=False):
        obj = cls()
        components = np.asarray(components)
        obj.components_ = components
        obj.mean_ = np.asarray(mean)
        obj.n_components = components.shape[0]
        obj.n_components_ = components.shape[0]
        obj.n_features_in_ = components.shape[1]
        obj.whiten = whiten
        if explained_variance is not None:
            obj.explained_variance_ = np.asarray(explained_variance)
        if explained_variance_ratio is not None:
            obj.explained_variance_ratio_ = np.asarray(explained_variance_ratio)
        if singular_values is not None:
            obj.singular_values_ = np.asarray(singular_values)
        if n_samples is not None:
            obj.n_samples_ = int(n_samples)
        obj.noise_variance_ = 0.0
        return obj


class StandardScalerShim:
    """Stand-in for fitted ``sklearn...StandardScaler`` (with_std=True)."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def transform(self, x):
        x = np.asarray(x)
        out = x - self.mean_ if getattr(self, "with_mean", True) else np.array(x)
        if getattr(self, "with_std", True):
            out = out / self.scale_
        return out

    def inverse_transform(self, x):
        x = np.asarray(x)
        if getattr(self, "with_std", True):
            x = x * self.scale_
        if getattr(self, "with_mean", True):
            x = x + self.mean_
        return x

    @classmethod
    def from_arrays(cls, mean, scale, n_samples=None):
        obj = cls()
        obj.mean_ = np.asarray(mean)
        obj.scale_ = np.asarray(scale)
        obj.var_ = obj.scale_ ** 2
        obj.with_mean = True
        obj.with_std = True
        obj.n_features_in_ = obj.mean_.shape[0]
        if n_samples is not None:
            obj.n_samples_seen_ = int(n_samples)
        return obj


# sklearn module paths that may appear in reference pickles (the paths
# moved across sklearn versions; cover the known spellings).
SKLEARN_CLASS_MAP = {
    ("sklearn.decomposition._pca", "PCA"): PCAShim,
    ("sklearn.decomposition.pca", "PCA"): PCAShim,
    ("sklearn.decomposition._incremental_pca", "IncrementalPCA"): PCAShim,
    ("sklearn.preprocessing._data", "StandardScaler"): StandardScalerShim,
    ("sklearn.preprocessing.data", "StandardScaler"): StandardScalerShim,
    # The shims as the JAX package pickles them where sklearn is absent.
    ("face_detection_recognization_pca_tpu.io.sklearn_shim", "PCAShim"): PCAShim,
    (
        "face_detection_recognization_pca_tpu.io.sklearn_shim",
        "StandardScalerShim",
    ): StandardScalerShim,
}
