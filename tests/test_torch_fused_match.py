"""Port parity: the fold and the fused projection-and-match of
``ops/fused_match.py`` against the JAX package's ``ops/pallas_kernels.py``
(its Pallas kernel in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tf32_emulation import dots_tf32, rna_tf32

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


@pytest.mark.parametrize("k", [300, 5000])
def test_fused_match_rejects_k_beyond_kernel_limit(k):
    """The kernel walks k in chunks, so its only limit is k >= 1: k = 300
    (several 64-feature chunks) and k = 5,000 (past the features the
    finish keeps in shared memory) are taken and equal the plain version,
    and an empty k is refused."""
    args = _good_args(k=k)
    ids, conf = tfm.fused_match(**args)
    lin = tfm.LinearizedModel(args["m"], args["bias"], args["gallery_t"], args["gnorm"],
                              torch.zeros(12, dtype=torch.int32), (1, 30))
    ids_p, conf_p = tfm.recognize_linearized(lin, args["crops_flat"], args["mask"])
    assert torch.equal(ids, ids_p) and torch.equal(conf, conf_p)
    args = _good_args(k=0)
    with pytest.raises(ValueError, match="empty operand"):
        tfm.fused_match(**args)


def test_fused_match_counts_no_launch_on_cpu():
    before = tfm.fused_match.launches
    tfm.fused_match(**_good_args())
    assert tfm.fused_match.launches == before


def _kernel_tf32(crops, m, bias, gallery_t, gnorm, passes):
    """The cosines of ``csrc/fused_match.cu`` emulated in float32, in its
    order of sums (3xTF32, or one TF32 pass).  The products: each D range
    of the wrapper's plan runs its 32-float chunks in order, 8-deep steps
    into one accumulator (``dots_tf32``); in 64-crop tiles the two
    warpgroups take alternate chunks and their accumulators are added,
    even chunks first.  The finish adds the ranges in ascending order from
    0, then the bias.  The scores: warp w takes the 8-deep steps w, w + 8,
    ... of k into its accumulator, and the warps' dots are added in warp
    order; divided by the norms as the kernel divides."""
    b, d = crops.shape
    k = m.shape[1]
    plan = tfm._grid(b, d, k)
    chunks = -(-d // 32)
    feats = np.zeros((b, k), np.float32)
    for s in range(plan.splits):
        parts = [[], []]
        for i, c in enumerate(range(s * plan.chunks_per_split,
                                    min(chunks, (s + 1) * plan.chunks_per_split))):
            parts[i % 2 if plan.tile_b == 64 else 0].append(slice(32 * c, min(d, 32 * c + 32)))
        partial = np.zeros((b, k), np.float32)
        for cols in parts:
            if cols:
                idx = np.concatenate([np.arange(d)[c] for c in cols])
                partial = partial + dots_tf32(crops[:, idx], m[idx].T, passes)
        feats = feats + partial
    feats = feats + bias
    fnorm = np.sqrt(np.sum(feats * feats, axis=1, dtype=np.float32))
    dots = np.zeros((b, gallery_t.shape[1]), np.float32)
    for w in range(8):
        idx = np.concatenate([np.arange(k0, min(k, k0 + 8)) for k0 in range(8 * w, k, 64)]
                             or [np.arange(0)])
        dots = dots + dots_tf32(feats[:, idx], gallery_t[idx].T, passes)
    return dots / (fnorm[:, None] * gnorm[None, :])


def test_3xtf32_projection_keeps_float32_parity_where_tf32_does_not():
    """The kernel's arithmetic, emulated on tracker-like data: pixel-valued
    crops (the tracker's 96 x 96 face, shifted and noised, B 64, D 9216),
    the port's linearize_model fold of a 64-component model trained on
    them, N 256, in the kernel's order of D ranges.  Its cosines lie within
    1e-6 of float64 and its ids equal the Pallas kernel's (interpret mode)
    and the JAX plain path's; one TF32 pass misses float64 by far more."""
    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.models.eigenfaces import train_v1

    _, gallery_images, _, _ = bench.tracker_assets(1, (400, 400), 1, 4, torch.device("cpu"))
    model, _ = train_v1(gallery_images, n_components=bench.N_COMPONENTS)
    lin = tfm.linearize_model(model, (bench.TPL, bench.TPL))
    m, bias, gallery_t, gnorm = (t.numpy() for t in (lin.m, lin.bias, lin.gallery_t,
                                                      lin.gallery_norm))
    rng = np.random.default_rng(0)
    crops = (gallery_images.numpy()[::4] + rng.normal(0, 3, (64, m.shape[0]))).astype(np.float32)

    f64 = crops.astype(np.float64) @ m.astype(np.float64) + bias
    exact = (f64 @ gallery_t.astype(np.float64)
             / np.linalg.norm(f64, axis=1)[:, None] / gnorm.astype(np.float64)[None, :])
    cos3 = _kernel_tf32(crops, m, bias, gallery_t, gnorm, 3)
    assert np.abs(cos3 - exact).max() <= 1e-6
    cos1 = _kernel_tf32(crops, m, bias, gallery_t, gnorm, 1)
    assert np.abs(cos1 - exact).max() > 1e-5

    jlin = jpk.LinearizedModel(jnp.asarray(m), jnp.asarray(bias), jnp.asarray(gallery_t),
                               jnp.asarray(gnorm), jnp.zeros(gnorm.shape, jnp.int32),
                               (bench.TPL, bench.TPL))
    ids_j, conf_j = jpk.fused_match_pallas(
        jnp.asarray(crops), jlin.m, jlin.bias, jlin.gallery_t, jlin.gallery_norm, tile_b=8,
        tile_d=1024, interpret=True)
    ids_x, _ = jpk.recognize_linearized(jlin, jnp.asarray(crops))
    np.testing.assert_array_equal(np.argmax(cos3, axis=1), np.asarray(ids_j))
    np.testing.assert_array_equal(np.asarray(ids_j), np.asarray(ids_x))
    np.testing.assert_allclose(cos3.max(axis=1), np.asarray(conf_j), rtol=0, atol=CONF_ATOL)


# The six shapes of the main paths (k 64, N 256) with the plans the
# wrapper gives them on a card of 132 SMs, then ragged cases.
@pytest.mark.parametrize(
    "b,d,k,tma,plan",
    [(32, 9216, 64, True, (58, 1, 1, 64, 5, 4)), (64, 9216, 64, True, (58, 1, 1, 64, 5, 4)),
     (64, 16384, 64, True, (64, 1, 1, 64, 8, 4)), (512, 9216, 64, True, (32, 1, 4, 128, 9, 8)),
     (768, 16384, 64, True, (22, 1, 6, 128, 24, 8)), (256, 9216, 64, True, (58, 1, 2, 128, 5, 8)),
     (130, 9216, 64, True, None), (6, 1024, 5000, True, None),
     (16, 4096, 300, True, None), (9, 2048, 7, True, None), (5, 4099, 8, False, None),
     (4, 576, 16, True, None), (1, 7, 1, False, None)],
)
def test_wrapper_picks_the_fill_and_sizes_grid_and_scratch(b, d, k, tma, plan):
    """TMA takes the crops only where they start on 16 bytes and D is a
    multiple of 4 (an offset view takes element loads).  The grid cuts D's 32-float chunks into
    equal ranges, none empty, at most _MAX_SPLITS of them, so that the
    products make at most one wave of blocks; B tiles are 64 crops up to
    _SMALL_B and 128 above, k chunks 64 features; the scratch holds one
    partial per (tile, k chunk, range)."""
    assert tfm._crops_tma(torch.zeros(b, d)) == tma
    assert not tfm._crops_tma(torch.zeros(b * d + 1)[1:].view(b, d))
    grid = tfm._grid(b, d, k)
    chunks = -(-d // 32)
    assert (grid.splits - 1) * grid.chunks_per_split < chunks <= grid.splits * grid.chunks_per_split
    assert 1 <= grid.splits <= tfm._MAX_SPLITS
    assert grid.tile_b == (64 if b <= tfm._SMALL_B else 128)
    assert (grid.tiles, grid.k_chunks) == (-(-b // grid.tile_b), -(-k // 64))
    assert grid.finish_rows == (4 if b <= tfm._SMALL_B else 8)
    assert grid.splits * grid.k_chunks * grid.tiles <= 132
    assert tfm._scratch_shape(b, d, k) == (grid.tiles, grid.k_chunks, grid.splits, grid.tile_b, 64)
    if plan is not None:
        assert tuple(grid) == plan


def test_split_m_is_the_3xtf32_split_and_matches_jax_through_the_plain_path():
    """split_m gives m's transpose, zero-padded to D rounded up to 4, as the
    TF32 halves hi = rna(m.T) and lo = rna(m.T - hi) that the kernel streams;
    linearize_model carries it, and LinearizedModel.to makes it again on
    the target device.  Through the plain path, m rebuilt from the halves
    gives the ids of the Pallas kernel (interpret mode), conf within
    CONF_ATOL."""
    rng = np.random.default_rng(21)
    m = (rng.normal(size=(257, 8)) / 16).astype(np.float32)  # D padded to 260
    split = tfm.split_m(torch.from_numpy(m))
    mt = np.zeros((8, 260), np.float32)
    mt[:, :257] = m.T
    hi = rna_tf32(mt)
    np.testing.assert_array_equal(split.hi.numpy(), hi)
    np.testing.assert_array_equal(split.lo.numpy(), rna_tf32(mt - hi))
    assert split.hi.is_contiguous() and split.lo.is_contiguous()
    np.testing.assert_allclose((split.hi + split.lo).numpy()[:, :257], m.T, rtol=2 ** -21, atol=0)

    b, d, k, n = 8, 256, 8, 40  # the Pallas kernel takes whole 128-deep D tiles
    m = (rng.normal(size=(d, k)) / 16).astype(np.float32)
    split = tfm.split_m(torch.from_numpy(m))
    bias = rng.normal(size=k).astype(np.float32)
    base = rng.normal(0, 25, (n, d)).astype(np.float32)
    feats = base @ m + bias
    gallery_t = np.ascontiguousarray(feats.T)
    gnorm = np.linalg.norm(feats, axis=1).astype(np.float32)
    crops = (base[[0, 3, 7, 11, 20, 21, 30, 39]] + rng.normal(0, 5, (b, d))).astype(np.float32)
    ids_j, conf_j = jpk.fused_match_pallas(
        jnp.asarray(crops), jnp.asarray(m), jnp.asarray(bias), jnp.asarray(gallery_t),
        jnp.asarray(gnorm), tile_b=8, tile_d=128, interpret=True)
    rebuilt = (split.hi + split.lo)[:, :d].T.contiguous()
    ids_t, conf_t = tfm.fused_match(torch.from_numpy(crops), rebuilt, torch.from_numpy(bias),
                                    torch.from_numpy(gallery_t), torch.from_numpy(gnorm),
                                    m_split=tfm.split_m(rebuilt))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j), rtol=0, atol=CONF_ATOL)

    _, tmodel, _ = _models(5)
    lin = tfm.linearize_model(tmodel, (12, 12))
    for got, want in zip(lin.m_split, tfm.split_m(lin.m)):
        assert torch.equal(got, want)
    moved = lin.to(torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(moved.m_split, lin.m_split))
    assert moved.crop_shape == lin.crop_shape


@pytest.mark.parametrize(
    "bad,exc",
    [(lambda s: s._replace(hi=s.hi.double()), TypeError),
     (lambda s: s._replace(lo=s.lo[:, :-4].contiguous()), ValueError),
     (lambda s: s._replace(hi=s.hi.T.contiguous().T), ValueError)],
)
def test_fused_match_checks_m_split(bad, exc):
    """A split form of m is float32, contiguous, (k, D rounded up to 4)."""
    args = _good_args()
    split = tfm.split_m(args["m"])
    tfm.fused_match(**args, m_split=split)
    with pytest.raises(exc):
        tfm.fused_match(**args, m_split=bad(split))


@pytest.mark.parametrize("scaled,crop_shape", [(False, (19, 15)), (True, (21, 13))])
def test_make_fused_recognizer_matches_jax_interpret(scaled, crop_shape):
    """D = 285 and 273 are no multiples of 128 (the JAX side pads D, k and N
    for its lanes; the port pads nothing), B = 11, k = 8, N = 40."""
    jmodel, tmodel, _ = _models(31, scaled=scaled)
    rng = np.random.default_rng(32)
    crops = rng.uniform(0, 255, (11, *crop_shape)).astype(np.float32)
    jfn, jlin = jpk.make_fused_recognizer(jmodel, crop_shape, interpret=True)
    tfn, tlin = tfm.make_fused_recognizer(tmodel, crop_shape)
    assert tlin.crop_shape == jlin.crop_shape == crop_shape
    np.testing.assert_allclose(tlin.m.numpy(), np.asarray(jlin.m), atol=1e-6)
    rows_ref, conf_ref = (np.asarray(a) for a in jfn(jnp.asarray(crops)))
    rows, conf = tfn(torch.from_numpy(crops))
    assert rows.shape == conf.shape == (11,) and rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), rows_ref)  # gallery rows, unpadded
    np.testing.assert_allclose(conf.numpy(), conf_ref, atol=CONF_ATOL)
    plain_rows, plain_conf = tfm.recognize_linearized(tlin, torch.from_numpy(crops))
    np.testing.assert_array_equal(rows.numpy(), plain_rows.numpy())
    np.testing.assert_array_equal(conf.numpy(), plain_conf.numpy())


def test_make_fused_recognizer_zero_norm_row_never_beats_a_positive_score():
    jmodel, tmodel, train = _models(33)
    gallery = np.asarray(jmodel.gallery).copy()
    gallery[0] = 0.0  # a zero-norm row scores 0
    tmodel.gallery.copy_(torch.from_numpy(gallery))
    crops = train[:5].reshape(5, 12, 12)
    rows, conf = tfm.make_fused_recognizer(tmodel, (12, 12))[0](torch.from_numpy(crops))
    jrows, jconf = jpk.make_fused_recognizer(
        jmodel.replace(gallery=jnp.asarray(gallery)), (12, 12), interpret=True
    )[0](jnp.asarray(crops))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), atol=CONF_ATOL)
    assert (rows != 0).all() and (conf > 0).all()
