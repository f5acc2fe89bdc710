"""The two PCA engines on tensors (port of ``linalg/pca.py``).

:func:`snapshot_pca` (v1): center, then if ``n < d`` eigendecompose the
n x n Gram matrix ``Xc Xc^T / (n-1)`` and back-project the eigenvectors
through ``Xc^T``; otherwise eigendecompose the d x d covariance.
``torch.linalg.eigh`` takes the place of XLA's eigensolver.  Eigenvector
signs are arbitrary per column, as in the JAX package: compare
projections up to a per-component sign.

:func:`scaled_pca` (v2): sklearn ``PCA.fit`` semantics on data the caller
has standardized -- SVD of the centered matrix with the deterministic
``svd_flip`` sign fix, so its components compare directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PCAResult(NamedTuple):
    """components ``(k, d)`` unit rows; mean ``(d,)``; projected ``(n, k)``;
    eigenvalues ``(k,)`` descending; explained_variance_ratio ``(k,)``."""

    components: torch.Tensor
    mean: torch.Tensor
    projected: torch.Tensor
    eigenvalues: torch.Tensor
    explained_variance_ratio: torch.Tensor


def _descending(eigval: torch.Tensor) -> torch.Tensor:
    # The JAX package's ``argsort(eigval)[::-1]``: a stable ascending sort
    # reversed, so equal eigenvalues keep that exact order.
    return torch.argsort(eigval, stable=True).flip(0)


def snapshot_pca(x: torch.Tensor, n_components: Optional[int] = None) -> PCAResult:
    """Gram-trick (snapshot) PCA of an ``(n, d)`` matrix; top-k defaults
    to ``min(n - 1, d)``.  Eigenvalues are those of the (n-1)-normalized
    Gram matrix, sorted descending; the ratio divides by their kept sum."""
    n, d = x.shape
    if n_components is None:
        n_components = min(n - 1, d)
    k = min(n_components, min(n, d))

    mean = x.mean(dim=0)
    xc = x - mean

    if n < d:
        gram = (xc @ xc.T) / (n - 1)
        eigval, eigvec = torch.linalg.eigh(gram)  # ascending
        order = _descending(eigval)[:k]
        eigval = eigval[order]
        comps = xc.T @ eigvec[:, order]  # (d, k)
        norms = torch.linalg.vector_norm(comps, dim=0)
        comps = comps / torch.where(norms > 0, norms, torch.ones_like(norms))
        components = comps.T.contiguous()  # (k, d)
    else:
        cov = (xc.T @ xc) / (n - 1)
        eigval, eigvec = torch.linalg.eigh(cov)
        order = _descending(eigval)[:k]
        eigval = eigval[order]
        components = eigvec[:, order].T.contiguous()  # (k, d)

    projected = xc @ components.T
    evr = eigval / eigval.sum()
    return PCAResult(components, mean, projected, eigval, evr)


def scaled_pca(x: torch.Tensor, n_components: int) -> PCAResult:
    """sklearn-``PCA.fit`` parity on (already standardized) ``(n, d)`` data.

    Thin SVD of the centered matrix; ``svd_flip`` decided on ``vt`` (the
    largest-|.| entry of each component row is made positive, an exact 0
    counts as +1), which removes the sign freedom a solver has, so two
    solvers agree after it.  Eigenvalues are ``s^2 / (n - 1)``; the ratio
    divides by the variance of *all* singular values, not the kept k,
    like ``PCA.explained_variance_ratio_``."""
    n, d = x.shape
    k = min(n_components, min(n, d))
    mean = x.mean(dim=0)
    xc = x - mean
    u, s, vt = torch.linalg.svd(xc, full_matrices=False)
    max_idx = torch.argmax(vt.abs(), dim=1)
    signs = torch.sign(vt[torch.arange(vt.shape[0], device=vt.device), max_idx])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    u = u * signs
    vt = vt * signs[:, None]

    eigval_all = (s * s) / (n - 1)
    total = eigval_all.sum()
    return PCAResult(
        vt[:k].contiguous(), mean, u[:, :k] * s[:k], eigval_all[:k], eigval_all[:k] / total
    )


def pca_fit(
    x: torch.Tensor, n_components: Optional[int] = None, method: str = "auto"
) -> PCAResult:
    """Dispatch between the engines (config knob ``TrainConfig.method``):
    ``"snapshot"``, ``"scaled"``, or ``"auto"`` (snapshot when ``n < d``)."""
    if method == "snapshot":
        return snapshot_pca(x, n_components)
    if method == "scaled":
        assert n_components is not None
        return scaled_pca(x, n_components)
    if method == "auto":
        n, d = x.shape
        if n < d:
            return snapshot_pca(x, n_components)
        return scaled_pca(x, n_components or min(n, d))
    raise ValueError(f"unknown PCA method: {method!r}")


def project(x: torch.Tensor, mean: torch.Tensor, components: torch.Tensor) -> torch.Tensor:
    """Project feature vectors into eigenspace: ``(x - mean) @ C^T``."""
    return (x - mean) @ components.T
