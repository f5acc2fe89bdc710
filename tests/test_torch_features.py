"""Port parity: the enhanced ensemble's feature extractors of
``ops/features.py`` against the JAX package's, on the same seeded uint8
crops under the suite's x64.  The uint8 outputs and the LBP histograms
are equal, HOG is held within 1e-6, and a batch's element equals the
single call."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.ops import features as jfeat
from face_detection_recognization_pca_tpu_torch.ops import features as tfeat

torch.set_num_threads(1)

HOG_ATOL = 1e-6  # float32 descriptors in [0, 1]


def _crops():
    """A random crop; one with flat and saturated areas (255, 0, 128
    blocks); a smooth odd-sized one whose top rows are saturated."""
    rng = np.random.default_rng(7)
    noisy = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    flat = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    flat[10:30, 10:40] = 255
    flat[40:, :20] = 0
    flat[30:50, 30:60] = 128
    yy, xx = np.mgrid[0:71, 0:53]
    smooth = np.clip(120 + 60 * np.sin(yy / 7.0) * np.cos(xx / 5.0), 0, 255).astype(np.uint8)
    smooth[:10] = 255
    return {"noisy": noisy, "flat_saturated": flat, "smooth_odd": smooth}


CROPS = _crops()
U8_FUNCS = ["equalize_hist_u8", "sharpen_u8", "gaussian_blur3_u8", "augment_face"]


@pytest.mark.parametrize("name", sorted(CROPS))
@pytest.mark.parametrize("fn", U8_FUNCS)
def test_u8_functions_equal_jax(fn, name):
    img = CROPS[name]
    want = np.asarray(getattr(jfeat, fn)(jnp.asarray(img)))
    got = getattr(tfeat, fn)(torch.from_numpy(img))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CROPS))
@pytest.mark.parametrize("alpha,beta", [(1.2, 10.0), (0.8, -10.0), (-1.5, 3.0)])
def test_convert_scale_abs_equals_jax(name, alpha, beta):
    img = CROPS[name]
    want = np.asarray(jfeat.convert_scale_abs(jnp.asarray(img), alpha, beta))
    got = tfeat.convert_scale_abs(torch.from_numpy(img), alpha, beta)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CROPS))
@pytest.mark.parametrize("degrees", [-5.0, 5.0, 30.0])
def test_rotation_equals_jax(name, degrees):
    """Bilinear samples rounded to uint8: one ulp of the sum would move a
    half-way value, so this holds map_coordinates' arithmetic order."""
    img = CROPS[name]
    want = np.asarray(jfeat.rotate_u8(jnp.asarray(img), degrees))
    np.testing.assert_array_equal(tfeat.rotate_u8(torch.from_numpy(img), degrees).numpy(), want)


@pytest.mark.parametrize("name", sorted(CROPS))
def test_lbp_histogram_equals_jax(name):
    """``sampled >= x`` on bilinear samples: the counts must be equal."""
    img = CROPS[name]
    want = np.asarray(jfeat.lbp_uniform_hist(jnp.asarray(img)))
    got = tfeat.lbp_uniform_hist(torch.from_numpy(img)).numpy()
    assert got.shape == (26,) and got.dtype == np.float32
    np.testing.assert_array_equal(np.rint(got * img.size), np.rint(want * img.size))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CROPS))
def test_hog_matches_jax(name):
    img = CROPS[name]
    want = np.asarray(jfeat.hog_features(jnp.asarray(img)))
    got = tfeat.hog_features(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=HOG_ATOL)


def test_hog_of_flat_image_is_zero():
    z = tfeat.hog_features(torch.full((64, 64), 100, dtype=torch.uint8))
    assert z.shape == (1764,) and float(z.abs().max()) == 0.0


@pytest.mark.parametrize(
    "fn", ["hog_features", "lbp_uniform_hist", "equalize_hist_u8", "sharpen_u8",
           "gaussian_blur3_u8", "augment_face"])
def test_batch_equals_single_calls(fn):
    rng = np.random.default_rng(3)
    batch = torch.from_numpy(rng.integers(0, 256, (2, 3, 40, 48), dtype=np.uint8))
    batch[1, 2, :10] = 255
    got = getattr(tfeat, fn)(batch)
    for i in range(2):
        for j in range(3):
            assert torch.equal(got[i, j], getattr(tfeat, fn)(batch[i, j]))


def test_rotation_and_convert_batch_equal_single_calls():
    rng = np.random.default_rng(4)
    batch = torch.from_numpy(rng.integers(0, 256, (3, 33, 41), dtype=np.uint8))
    rot = tfeat.rotate_u8(batch, 5.0)
    csa = tfeat.convert_scale_abs(batch, 1.2, 10.0)
    for i in range(3):
        assert torch.equal(rot[i], tfeat.rotate_u8(batch[i], 5.0))
        assert torch.equal(csa[i], tfeat.convert_scale_abs(batch[i], 1.2, 10.0))
