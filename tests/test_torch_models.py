"""Port parity: ``ops/resize.py``, ``ops/similarity.py`` and
``models/eigenfaces.py`` (training, projection, weight carry-over)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.models import eigenfaces as jef
from face_detection_recognization_pca_tpu.ops import resize as jresize
from face_detection_recognization_pca_tpu.ops import similarity as jsim
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as tef
from face_detection_recognization_pca_tpu_torch.ops import resize as tresize
from face_detection_recognization_pca_tpu_torch.ops import similarity as tsim

torch.set_num_threads(1)


def _params(jmodel):
    return {
        name: None if getattr(jmodel, name) is None else np.asarray(getattr(jmodel, name))
        for name in tef.PARAM_NAMES
    }


@pytest.mark.parametrize("src,dsize", [((37, 29), (64, 64)), ((96, 96), (24, 40))])
def test_resize_bilinear_matches_jax(src, dsize):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (2, *src)).astype(np.float32)
    np.testing.assert_array_equal(tresize._interp_matrix(src[0], dsize[1], np.float32),
                                  jresize._interp_matrix(src[0], dsize[1], np.float32))
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(img), dsize))
    got = tresize.resize_bilinear(torch.from_numpy(img), dsize)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-4)


def test_cosine_gallery_and_best_match_match_jax():
    rng = np.random.default_rng(3)
    probes = rng.normal(size=(6, 8))
    gallery = rng.normal(size=(10, 8))
    gallery[4] = 0.0  # zero-norm row scores 0
    probes[5] = 0.0  # zero-norm probe scores 0 everywhere
    gallery[7] = gallery[2]  # an exact tie with row 2: the first wins
    probes[1] = gallery[2]
    labels = np.arange(10, dtype=np.int32) * 10
    ref = np.array(jsim.cosine_gallery(jnp.asarray(probes), jnp.asarray(gallery)))
    got = tsim.cosine_gallery(torch.from_numpy(probes), torch.from_numpy(gallery))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    assert (got[:, 4] == 0).all() and (got[5] == 0).all()
    ids_r, conf_r = jsim.best_match(jnp.asarray(ref), jnp.asarray(labels), 0.5)
    ids_t, conf_t = tsim.best_match(torch.from_numpy(ref), torch.from_numpy(labels), 0.5)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_r), rtol=1e-12)
    assert ids_t[1] == 20 and ids_t[5] == -1


def test_train_v1_matches_jax():
    rng = np.random.default_rng(4)
    images = rng.normal(120, 30, (24, 16 * 16))
    jmodel, jaux = jef.train_v1(jnp.asarray(images), n_components=10)
    tmodel, taux = tef.train_v1(torch.from_numpy(images), n_components=10)
    assert tmodel.face_shape == jmodel.face_shape == (16, 16)
    assert tmodel.schema == "v1" and tmodel.scaler_mean is None
    assert tmodel.labels.dtype == torch.int32 and tmodel.n_components == 10
    np.testing.assert_allclose(taux["eigenvalues"].numpy(), np.asarray(jaux["eigenvalues"]),
                               rtol=1e-10)
    # Projections through each model agree up to a per-component sign.
    probe = rng.normal(120, 30, (5, 256))
    got = tef.project_vectors(tmodel, torch.from_numpy(probe)).numpy()
    ref = np.asarray(jef.project_vectors(jmodel, jnp.asarray(probe)))
    sign = np.sign(np.sum(got * ref, axis=0))
    np.testing.assert_allclose(got * sign, ref, atol=1e-8)


@pytest.mark.parametrize("schema", ["v1", "v2"])
def test_from_params_carries_a_jax_model_over(schema):
    rng = np.random.default_rng(6)
    d, k, n = 64, 5, 9
    scaled = schema == "v2"
    jmodel = jef.EigenfacesModel(
        components=jnp.asarray(rng.normal(size=(k, d)).astype(np.float32)),
        projection_mean=jnp.asarray(rng.normal(size=d).astype(np.float32)),
        mean_face=jnp.asarray(rng.normal(size=d).astype(np.float32)),
        gallery=jnp.asarray(rng.normal(size=(n, k)).astype(np.float32)),
        labels=jnp.asarray(np.arange(n, dtype=np.int32) % 2),
        scaler_mean=jnp.asarray(rng.normal(size=d).astype(np.float32)) if scaled else None,
        scaler_scale=jnp.asarray(rng.uniform(1, 2, d).astype(np.float32)) if scaled else None,
        face_shape=(8, 8),
        schema=schema,
    )
    tmodel = tef.from_params(_params(jmodel), (8, 8), schema, torch.device("cpu"))
    assert isinstance(tmodel, torch.nn.Module)
    assert tmodel.face_shape == (8, 8) and tmodel.schema == schema
    assert set(dict(tmodel.named_buffers())) == {
        name for name in tef.PARAM_NAMES if getattr(jmodel, name) is not None
    }
    back = tef.to_params(tmodel)
    for name, value in _params(jmodel).items():
        if value is None:
            assert back[name] is None
        else:
            np.testing.assert_array_equal(back[name], value)
            assert back[name].dtype == value.dtype
    flat = rng.normal(100, 20, (3, d)).astype(np.float32)
    np.testing.assert_allclose(
        tef.project_vectors(tmodel, torch.from_numpy(flat)).numpy(),
        np.asarray(jef.project_vectors(jmodel, jnp.asarray(flat))),
        rtol=1e-5, atol=1e-4,
    )
