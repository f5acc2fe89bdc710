"""Port parity: the fold and the fused projection-and-match of
``ops/fused_match.py`` against the JAX package's ``ops/pallas_kernels.py``
(its Pallas kernel in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.models import eigenfaces as jef
from face_detection_recognization_pca_tpu.ops import pallas_kernels as jpk
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as tef
from face_detection_recognization_pca_tpu_torch.ops import fused_match as tfm

torch.set_num_threads(1)

# Both sides sum float32 products in different orders; cosines are <= 1.
CONF_ATOL = 1e-5


def _params(jmodel):
    return {
        name: None if getattr(jmodel, name) is None else np.asarray(getattr(jmodel, name))
        for name in tef.PARAM_NAMES
    }


def _models(seed, face_shape=(12, 12), k=8, n=40, scaled=False, zero_mean=False,
            tie=None):
    """A JAX model with orthonormal components whose gallery rows project
    ``n`` random training crops, its port, and those training crops."""
    rng = np.random.default_rng(seed)
    d = face_shape[0] * face_shape[1]
    comps = np.linalg.qr(rng.normal(size=(d, k)))[0].T.astype(np.float32)
    train = rng.normal(120, 30, (n, d)).astype(np.float32)
    smean = sscale = None
    x = train
    if scaled:
        smean = train.mean(0)
        sscale = train.std(0) + 0.5
        x = (train - smean) / sscale
    pmean = np.zeros(d, np.float32) if zero_mean else x.mean(0).astype(np.float32)
    gallery = ((x - pmean) @ comps.T).astype(np.float32)
    if tie is not None:
        gallery[tie[1]] = gallery[tie[0]]
    jmodel = jef.EigenfacesModel(
        components=jnp.asarray(comps),
        projection_mean=jnp.asarray(pmean),
        mean_face=jnp.asarray(train.mean(0)),
        gallery=jnp.asarray(gallery),
        labels=jnp.asarray(np.arange(n, dtype=np.int32) % 3),
        scaler_mean=None if smean is None else jnp.asarray(smean.astype(np.float32)),
        scaler_scale=None if sscale is None else jnp.asarray(sscale.astype(np.float32)),
        face_shape=face_shape,
        schema="v2" if scaled else "v1",
    )
    tmodel = tef.from_params(_params(jmodel), face_shape, jmodel.schema, torch.device("cpu"))
    return jmodel, tmodel, train


@pytest.mark.parametrize(
    "scaled,crop_shape", [(False, (12, 12)), (True, (12, 12)), (True, (20, 17))]
)
def test_linearize_model_matches_jax(scaled, crop_shape):
    jmodel, tmodel, _ = _models(0, scaled=scaled)
    jlin = jpk.linearize_model(jmodel, crop_shape)
    tlin = tfm.linearize_model(tmodel, crop_shape)
    for field in ("m", "bias", "gallery_t", "gallery_norm"):
        got = getattr(tlin, field)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jlin, field)),
                                   rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tlin.labels.numpy(), np.asarray(jlin.labels))
    assert tlin.crop_shape == jlin.crop_shape


def _case(name):
    """(jax model, port model, crops (B, 12, 12)) for one recognition case."""
    rng = np.random.default_rng(7)
    if name == "tie":
        jmodel, tmodel, train = _models(1, tie=(3, 7))
        crops = train[[3, 3, 9, 20, 7, 0, 39, 12]] + rng.normal(0, 3, (8, 144))
    elif name == "zero_norm":
        jmodel, tmodel, train = _models(2, zero_mean=True)
        crops = train[[5, 6, 7, 8, 1, 2, 3, 4]] + rng.normal(0, 3, (8, 144))
        crops[2] = 0.0
    else:
        jmodel, tmodel, train = _models(3)
        b = 5 if name == "odd_batch" else 8
        crops = train[rng.permutation(40)[:b]] + rng.normal(0, 3, (b, 144))
    return jmodel, tmodel, crops.reshape(-1, 12, 12).astype(np.float32)


@pytest.mark.parametrize("name", ["near_rows", "odd_batch", "tie", "zero_norm"])
def test_fused_match_matches_jax_kernel(name):
    """N = 40 is padded to 128 and masked inside the JAX recognizer; the
    port scores the 40 rows as they are."""
    jmodel, tmodel, crops = _case(name)
    fn, jlin = jpk.make_fused_recognizer(jmodel, (12, 12), tile_b=8, interpret=True)
    ids_j, conf_j = (np.asarray(a) for a in fn(crops))
    ids_x, conf_x = (np.asarray(a) for a in jpk.recognize_linearized(jlin, crops))

    tlin = tfm.linearize_model(tmodel, (12, 12))
    flat = torch.from_numpy(crops.reshape(len(crops), -1))
    ids_t, conf_t = tfm.fused_match(flat, tlin.m, tlin.bias, tlin.gallery_t, tlin.gallery_norm)
    ids_p, conf_p = tfm.recognize_linearized(tlin, torch.from_numpy(crops))

    assert ids_t.dtype == torch.int32 and conf_t.dtype == torch.float32
    for ids, conf in ((ids_j, conf_j), (ids_x, conf_x), (ids_p.numpy(), conf_p.numpy())):
        np.testing.assert_array_equal(ids_t.numpy(), ids)
        np.testing.assert_allclose(conf_t.numpy(), conf, rtol=0, atol=CONF_ATOL)
    if name == "tie":
        assert ids_t[0] == 3 and ids_t[1] == 3  # rows 3 and 7 tie; the first wins
    if name == "zero_norm":
        assert ids_t[2] == 0 and conf_t[2] == 0.0
    if name in ("near_rows", "odd_batch"):
        assert conf_t.min() > 0.95


def test_fused_match_mask_matches_jax_pallas():
    """An explicit additive mask: crops near masked rows must go elsewhere,
    exactly as the Pallas kernel (two K tiles) decides."""
    rng = np.random.default_rng(11)
    b, d, k, n = 8, 256, 8, 40
    m = (rng.normal(size=(d, k)) / 16).astype(np.float32)
    bias = rng.normal(size=k).astype(np.float32)
    base = rng.normal(0, 25, (n, d)).astype(np.float32)
    feats = base @ m + bias
    gallery_t = np.ascontiguousarray(feats.T)
    gnorm = np.linalg.norm(feats, axis=1).astype(np.float32)
    mask = np.where(np.arange(n) >= 36, -np.inf, 0.0).astype(np.float32)
    crops = (base[[0, 36, 37, 38, 39, 5, 20, 35]] + rng.normal(0, 5, (b, d))).astype(np.float32)

    ids_j, conf_j = jpk.fused_match_pallas(
        jnp.asarray(crops), jnp.asarray(m), jnp.asarray(bias), jnp.asarray(gallery_t),
        jnp.asarray(gnorm), gallery_mask=jnp.asarray(mask), tile_b=8, tile_d=128,
        interpret=True,
    )
    ids_t, conf_t = tfm.fused_match(*(torch.from_numpy(a) for a in
                                      (crops, m, bias, gallery_t, gnorm, mask)))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j), rtol=0, atol=CONF_ATOL)
    assert (ids_t < 36).all()
    assert ids_t[0] == 0 and ids_t[5] == 5


def _good_args(b=4, d=30, k=8, n=12):
    g = torch.Generator().manual_seed(0)
    return dict(
        crops_flat=torch.randn(b, d, generator=g), m=torch.randn(d, k, generator=g),
        bias=torch.randn(k, generator=g), gallery_t=torch.randn(k, n, generator=g),
        gnorm=torch.rand(n, generator=g), mask=torch.zeros(n),
    )


@pytest.mark.parametrize(
    "field,bad,exc",
    [
        ("crops_flat", lambda a: a.double(), TypeError),
        ("m", lambda a: a.half(), TypeError),
        ("mask", lambda a: a.to(torch.int32), TypeError),
        ("crops_flat", lambda a: a.reshape(-1), ValueError),
        ("m", lambda a: a[:-1].contiguous(), ValueError),
        ("bias", lambda a: a[:-1], ValueError),
        ("gnorm", lambda a: torch.cat([a, a]), ValueError),
        ("mask", lambda a: a[:-2], ValueError),
        ("m", lambda a: a.T.contiguous().T, ValueError),  # not contiguous
        ("crops_flat", lambda a: a[:0], ValueError),  # empty batch
    ],
)
def test_fused_match_rejects_bad_args(field, bad, exc):
    args = _good_args()
    tfm.fused_match(**args)  # the untouched arguments are accepted
    args[field] = bad(args[field])
    with pytest.raises(exc):
        tfm.fused_match(**args)


def test_fused_match_rejects_k_beyond_kernel_limit():
    args = _good_args(k=tfm.MAX_K + 1)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        tfm.fused_match(**args)


def test_fused_match_counts_no_launch_on_cpu():
    before = tfm.fused_match.launches
    tfm.fused_match(**_good_args())
    assert tfm.fused_match.launches == before
