"""Port parity: ``ops/resize.py``, ``ops/similarity.py``, ``ops/color.py``,
``ops/preprocess.py`` and ``models/eigenfaces.py`` (training, projection,
feature extraction, recognition, weight carry-over, and the v2 trainer with
its model files crossing between the packages)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.io import artifacts as jart
from face_detection_recognization_pca_tpu.models import eigenfaces as jef
from face_detection_recognization_pca_tpu.ops import color as jcolor
from face_detection_recognization_pca_tpu.ops import preprocess as jpre
from face_detection_recognization_pca_tpu.ops import resize as jresize
from face_detection_recognization_pca_tpu.ops import similarity as jsim
from face_detection_recognization_pca_tpu_torch.io import artifacts as tart
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as tef
from face_detection_recognization_pca_tpu_torch.ops import color as tcolor
from face_detection_recognization_pca_tpu_torch.ops import preprocess as tpre
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


def test_color_conversions_match_jax():
    rng = np.random.default_rng(8)
    bgr = rng.integers(0, 256, (3, 17, 11, 3), dtype=np.uint8)
    bgr[0, 0, :3] = [[0, 0, 0], [255, 255, 255], [1, 128, 254]]
    exact = tcolor.bgr_to_gray_exact(torch.from_numpy(bgr))
    assert exact.dtype == torch.uint8 and exact.shape == (3, 17, 11)
    np.testing.assert_array_equal(exact.numpy(), np.asarray(jcolor.bgr_to_gray_exact(bgr)))
    for name in ("bgr_to_gray", "rgb_to_gray"):
        got = getattr(tcolor, name)(torch.from_numpy(bgr))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jcolor, name)(bgr)),
                                   rtol=1e-6, atol=1e-4)
    # The float path stays within one uint8 step of the exact one.
    assert float((tcolor.bgr_to_gray(torch.from_numpy(bgr)) - exact).abs().max()) <= 1.0


@pytest.mark.parametrize("shape", [(4, 30, 26), (4, 30, 26, 3)])
def test_preprocess_crops_match_jax(shape):
    rng = np.random.default_rng(9)
    crops = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(jpre.preprocess_crops(jnp.asarray(crops), (20, 24)))
    got = tpre.preprocess_crops(torch.from_numpy(crops), (20, 24))
    assert got.shape == ref.shape == (4, 480) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-3)
    one = tpre.preprocess_crop(torch.from_numpy(crops[1]), (20, 24))
    np.testing.assert_allclose(one.numpy(), got[1].numpy(), rtol=1e-6, atol=1e-4)
    # The exact path is whole uint8 steps near the float path (gray and
    # resize each round once); tests/test_torch_resize_exact.py holds it
    # against JAX bit for bit.
    exact = tpre.preprocess_crops(torch.from_numpy(crops), (20, 24), exact=True)
    assert torch.equal(exact, exact.round()) and float((exact - got).abs().max()) <= 1.5


def _jax_model(schema, rng, d_side=16, n=18, k=7):
    d = d_side * d_side
    images = rng.uniform(0, 255, (n, d)).astype(np.float32)
    labels = jnp.asarray(np.arange(n, dtype=np.int32) % 5)
    if schema == "v1":
        jmodel, _ = jef.train_v1(jnp.asarray(images), n_components=k)
        jmodel = jmodel.replace(labels=labels)
    else:
        jmodel, _ = jef.train_v2(jnp.asarray(images), labels, n_components=k,
                                 face_shape=(d_side, d_side))
    jmodel = jmodel.replace(**{
        name: getattr(jmodel, name).astype(jnp.float32)
        for name in tef.PARAM_NAMES
        if getattr(jmodel, name) is not None and name != "labels"
    })
    return jmodel, images


@pytest.mark.parametrize("schema", ["v1", "v2"])
@pytest.mark.parametrize("color", ["gray", "bgr"])
def test_extract_features_and_recognize_match_jax(schema, color):
    """Crops of 21 x 19 (resized to the 16 x 16 face), gray or BGR; half
    of them near training faces so ids above the threshold show up."""
    rng = np.random.default_rng(10)
    jmodel, images = _jax_model(schema, rng)
    tmodel = tef.from_params(_params(jmodel), jmodel.face_shape, jmodel.schema,
                             torch.device("cpu"))
    faces = images[:6].reshape(6, 16, 16)
    near = np.asarray(jresize.resize_bilinear(jnp.asarray(faces), (19, 21)))
    crops = np.concatenate([near + rng.normal(0, 2, near.shape),
                            rng.uniform(0, 255, (6, 21, 19))]).astype(np.float32)
    if color == "bgr":
        crops = np.repeat(np.clip(crops, 0, 255).astype(np.uint8)[..., None], 3, axis=-1)
    feats_j = np.asarray(jef.extract_features(jmodel, jnp.asarray(crops)))
    feats_t = tef.extract_features(tmodel, torch.from_numpy(crops))
    assert feats_t.dtype == torch.float32 and feats_t.shape == (12, 7)
    scale = np.abs(feats_j).max()
    np.testing.assert_allclose(feats_t.numpy(), feats_j, rtol=0, atol=1e-5 * scale)
    ids_j, conf_j = jef.recognize(jmodel, jnp.asarray(crops), threshold=0.9)
    ids_t, conf_t = tef.recognize(tmodel, torch.from_numpy(crops), threshold=0.9)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j), rtol=0, atol=1e-5)
    assert (ids_t[:6] == torch.arange(6) % 5).all()


def _v2_training_set(seed=8, n=30, side=12):
    """Flattened crops of 3 persons with a decaying spectrum, and labels."""
    rng = np.random.default_rng(seed)
    d = side * side
    basis = np.linalg.qr(rng.normal(size=(d, n)))[0]
    coeffs = rng.normal(size=(n, n)) * np.linspace(40.0, 2.0, n)
    images = 120.0 + coeffs @ basis.T + rng.normal(0, 0.5, (n, d))
    return images, (np.arange(n) % 3).astype(np.int64)


def test_train_v2_matches_jax_f64():
    images, labels = _v2_training_set()
    jmodel, jaux = jef.train_v2(jnp.asarray(images), jnp.asarray(labels), 10, (12, 12))
    tmodel, taux = tef.train_v2(torch.from_numpy(images), torch.from_numpy(labels), 10, (12, 12))
    assert tmodel.schema == "v2" and tmodel.face_shape == (12, 12)
    assert tmodel.labels.dtype == torch.int32 and tmodel.n_components == 10
    # svd_flip fixes every sign, so the bases compare directly: 1e-8.
    for name in tef.PARAM_NAMES:
        np.testing.assert_allclose(getattr(tmodel, name).numpy(),
                                   np.asarray(getattr(jmodel, name)), atol=1e-8, err_msg=name)
    for key in ("eigenvalues", "explained_variance_ratio"):
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]), atol=1e-8)
    probe = images[:4] + 0.25
    np.testing.assert_allclose(
        tef.project_vectors(tmodel, torch.from_numpy(probe)).numpy(),
        np.asarray(jef.project_vectors(jmodel, jnp.asarray(probe))), atol=1e-8,
    )


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_train_v2_model_saved_by_one_package_recognises_through_the_other(writer, tmp_path):
    images, labels = _v2_training_set()
    id_map = {"ann": 0, "bob": 1, "cy": 2}
    path = str(tmp_path / "face_model.pkl")
    crops = images[[0, 4, 8]].reshape(3, 12, 12)
    if writer == "jax":
        model, aux = jef.train_v2(jnp.asarray(images), jnp.asarray(labels), 10, (12, 12))
        jart.save_model_v2(jef.to_artifact(model, aux, person_id_map=id_map), path)
        art = tart.load_model(path)
        ids, conf = tef.recognize(
            tef.from_artifact(art, torch.float64, torch.device("cpu")), torch.from_numpy(crops)
        )
        ids, conf = ids.numpy(), conf.numpy()
    else:
        model, aux = tef.train_v2(torch.from_numpy(images), torch.from_numpy(labels), 10, (12, 12))
        tart.save_model_v2(tef.to_artifact(model, aux, person_id_map=id_map), path)
        art = jart.load_model(path)
        ids, conf = (np.asarray(a) for a in
                     jef.recognize(jef.from_artifact(art, jnp.float64), jnp.asarray(crops)))
    assert art.schema == "v2" and art.person_id_map == id_map
    assert art.eigenvalues is not None and art.eigenvalues.shape == (10,)
    # Each training crop finds its own gallery row: cosine 1, its label.
    np.testing.assert_array_equal(ids, labels[[0, 4, 8]])
    np.testing.assert_allclose(conf, 1.0, atol=1e-9)


def test_apply_scaler_cosine_similarity_and_euclidean_gallery_match_jax():
    rng = np.random.default_rng(12)
    x = rng.normal(100, 20, (5, 9))
    mean, scale = rng.normal(100, 5, 9), rng.uniform(1, 3, 9)
    for sc in (scale, None):
        np.testing.assert_allclose(
            tpre.apply_scaler(torch.from_numpy(x), torch.from_numpy(mean),
                              None if sc is None else torch.from_numpy(sc)).numpy(),
            np.asarray(jpre.apply_scaler(jnp.asarray(x), jnp.asarray(mean),
                                         None if sc is None else jnp.asarray(sc))),
            rtol=1e-12,
        )
    a, b = rng.normal(size=(6, 9)), rng.normal(size=(6, 9))
    a[2] = 0.0  # a zero norm scores 0
    got = tsim.cosine_similarity(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jsim.cosine_similarity(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-12, atol=1e-15)
    assert got[2] == 0
    gallery = rng.normal(size=(7, 9))
    gallery[3] = a[1]  # distance 0, clipped before the root
    dist = tsim.euclidean_gallery(torch.from_numpy(a), torch.from_numpy(gallery))
    np.testing.assert_allclose(
        dist.numpy(), np.asarray(jsim.euclidean_gallery(jnp.asarray(a), jnp.asarray(gallery))),
        rtol=1e-9, atol=1e-7,
    )
    assert dist[1, 3] < 1e-6


@pytest.mark.parametrize(
    "box,out_size",
    [((10.0, 6.0, 24.0, 18.0), (16, 16)),  # inside, downscale
     ((3.0, 2.0, 9.0, 7.0), (20, 12)),  # inside, upscale
     ((0.0, 0.0, 40.0, 30.0), (13, 11)),  # the whole frame
     ((-4.0, -3.0, 20.0, 16.0), (10, 8))],  # reaches outside: zeros and renormalised taps
)
def test_crop_resize_dynamic_matches_jax(box, out_size):
    rng = np.random.default_rng(13)
    frame = rng.uniform(0, 255, (30, 40)).astype(np.float32)
    ref = np.asarray(jpre.crop_resize_dynamic(jnp.asarray(frame), jnp.asarray(box, jnp.float32),
                                              out_size))
    got = tpre.crop_resize_dynamic(torch.from_numpy(frame), torch.tensor(box), out_size)
    assert got.shape == ref.shape == (out_size[1], out_size[0])
    # Held to the JAX output at 1e-5 of the pixel range: both sides place
    # their sample points in float32, and a last-bit difference there times
    # a pixel-to-pixel step of up to 255 is what remains.
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * 255)
    if box[0] < 0:
        assert (got[0] == 0).all() and (got[:, 0] == 0).all()  # sampled beyond the edge
