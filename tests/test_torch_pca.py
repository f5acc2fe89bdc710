"""Port parity: ``linalg/pca.py`` and ``linalg/standardize.py`` against the
JAX package, in float64 (the suite runs JAX with x64 on)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.linalg import pca as jpca
from face_detection_recognization_pca_tpu.linalg import standardize as jstd
from face_detection_recognization_pca_tpu_torch.linalg import pca as tpca
from face_detection_recognization_pca_tpu_torch.linalg import standardize as tstd

torch.set_num_threads(1)


def _data(n, d, seed=0):
    """Rows with a decaying spectrum, so the kept eigenvalues are distinct."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.normal(size=(d, min(n, d))))[0]
    coeffs = rng.normal(size=(n, min(n, d))) * np.linspace(10.0, 1.0, min(n, d))
    return coeffs @ basis.T + rng.normal(0, 0.01, (n, d)) + 5.0


@pytest.mark.parametrize(
    "n,d,k",
    [(20, 50, 10), (20, 50, None), (60, 12, 6)],  # Gram branch, default k, covariance branch
)
def test_snapshot_pca_matches_jax_f64(n, d, k):
    x = _data(n, d)
    ref = jpca.snapshot_pca(jnp.asarray(x), k)
    got = tpca.snapshot_pca(torch.from_numpy(x), k)
    assert got.components.dtype == torch.float64
    np.testing.assert_allclose(got.eigenvalues.numpy(), np.asarray(ref.eigenvalues), rtol=1e-10)
    np.testing.assert_allclose(got.explained_variance_ratio.numpy(),
                               np.asarray(ref.explained_variance_ratio), rtol=1e-10)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=1e-12)
    # Each eigenvector's sign is arbitrary: align components and projections
    # by the sign of their dot product with the reference.
    comps_ref = np.asarray(ref.components)
    sign = np.sign(np.sum(got.components.numpy() * comps_ref, axis=1))
    np.testing.assert_allclose(got.components.numpy() * sign[:, None], comps_ref, atol=1e-8)
    np.testing.assert_allclose(got.projected.numpy() * sign[None, :],
                               np.asarray(ref.projected), atol=1e-8)
    proj = tpca.project(torch.from_numpy(x), got.mean, got.components)
    np.testing.assert_allclose(proj.numpy(), got.projected.numpy(), atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scaler_matches_jax(dtype):
    x = _data(30, 16, seed=1).astype(dtype)
    if dtype == np.float64:
        # Zero-variance column: scale guarded to 1.  Not in float32, where
        # XLA's mean of a constant column is off by an ulp, so the JAX
        # scaler sees a std of ~5e-7 there and keeps it.
        x[:, 3] = 7.0
    ref = jstd.scaler_fit(jnp.asarray(x))
    got = tstd.scaler_fit(torch.from_numpy(x))
    rtol = 1e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=rtol)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale), rtol=rtol)
    if dtype == np.float64:
        assert got.scale[3] == 1.0
    np.testing.assert_allclose(
        tstd.scaler_transform(torch.from_numpy(x), got).numpy(),
        np.asarray(jstd.scaler_transform(jnp.asarray(x), ref)),
        rtol=rtol, atol=rtol,
    )
