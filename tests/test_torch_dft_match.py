"""Port parity: the DFT-as-matmul circular correlator of ``ops/dft_match.py``."""

import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.ops import dft_match as jdft
from face_detection_recognization_pca_tpu_torch.ops import dft_match as tdft

torch.set_num_threads(1)


@pytest.mark.parametrize("n,out", [(128, 65), (192, 97)])  # test size; tracker geometry
def test_circular_correlator_matches_jax(n, out):
    rng = np.random.default_rng(5)
    tpl = n - out + 1
    kernel = rng.normal(0, 30, (tpl, tpl)).astype(np.float32)
    w = rng.normal(0, 25, (3, n, n)).astype(np.float32)
    ref = np.asarray(jdft.make_circular_correlator(kernel, n, out)(w))
    got = tdft.make_circular_correlator(kernel, n, out, device="cpu")(torch.from_numpy(w))
    assert got.shape == (3, out, out) and got.dtype == torch.float32
    # float32 matmul chains summed in other orders; scale the bound by the peak.
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_dft_matrices_are_the_jax_packages():
    for a, b in zip(tdft._dft_mats_np(64, 33), jdft._dft_mats_np(64, 33)):
        np.testing.assert_array_equal(a, b)


def test_circular_correlator_rejects_aliasing():
    with pytest.raises(ValueError, match="alias-free"):
        tdft.make_circular_correlator(np.ones((40, 40), np.float32), 64, 30, device="cpu")
