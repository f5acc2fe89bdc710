"""Port parity: ``ops/gallery_match.py`` against the JAX package's
``gallery_match_pallas`` (its Pallas kernel in interpret mode), mirroring
``tests/test_pallas_fused.py``'s streaming-kernel cases, plus ragged B and
N (the JAX side padded to its tiles, the port's taken as they are) and a
zero-norm feature."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tf32_emulation import dots_tf32

from face_detection_recognization_pca_tpu.ops.pallas_kernels import gallery_match_pallas
from face_detection_recognization_pca_tpu_torch.ops import gallery_match as tgm

torch.set_num_threads(1)

# Float32 dot products summed in other orders; cosines are <= 1.
BEST_ATOL = 1e-6


def _port(feats, gallery, gnorm, layout="k_n", operand_dtype=None):
    """The port on ``gallery`` (N, k) given as a contiguous (k, N) or as
    the ``.T`` view of the (N, k) rows."""
    g = torch.from_numpy(np.ascontiguousarray(gallery))
    gallery_t = g.T.contiguous() if layout == "k_n" else g.T
    idx, best = tgm.gallery_match(torch.from_numpy(feats), gallery_t, torch.from_numpy(gnorm),
                                  operand_dtype=operand_dtype)
    assert idx.dtype == torch.int32 and best.dtype == torch.float32
    return idx.numpy(), best.numpy()


def _jax(feats, gallery, gnorm, tile_b, tile_n, operand_dtype=None):
    """The Pallas kernel in interpret mode, B and N padded to its tiles:
    zero feature rows, and gallery rows with the sentinel norm -1."""
    b, n = feats.shape[0], gallery.shape[0]
    bp, np_ = -(-b // tile_b) * tile_b, -(-n // tile_n) * tile_n
    f = np.pad(feats, ((0, bp - b), (0, 0)))
    g = np.pad(gallery, ((0, np_ - n), (0, 0)))
    gn = np.pad(gnorm, (0, np_ - n), constant_values=-1.0)
    idx, best = gallery_match_pallas(jnp.asarray(f), jnp.asarray(g.T), jnp.asarray(gn),
                                     tile_b=tile_b, tile_n=tile_n, interpret=True,
                                     operand_dtype=operand_dtype)
    return np.asarray(idx)[:b], np.asarray(best)[:b]


def _assert_same(port, ref, atol=BEST_ATOL):
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_allclose(port[1], ref[1], rtol=0, atol=atol)


@pytest.mark.parametrize("layout", ["k_n", "rows"])
def test_streams_tiles_like_jax(rng, layout):
    """Cross-tile winners, the sentinel (an exact match planted in an
    invalid row must lose) and a valid zero-norm row scoring 0."""
    b, k, n = 8, 16, 64
    feats = rng.normal(0, 1, (b, k)).astype(np.float32)
    gallery = rng.normal(0, 1, (n, k)).astype(np.float32)
    gallery[3] = feats[0]
    gallery[40] = feats[1]
    gallery[62] = feats[2]  # invalid row: must lose
    gallery[10] = 0.0  # valid zero-norm row
    gnorm = np.linalg.norm(gallery, axis=1).astype(np.float32)
    gnorm[60:] = -1.0
    got = _port(feats, gallery, gnorm, layout)
    _assert_same(got, _jax(feats, gallery, gnorm, tile_b=8, tile_n=16))
    assert got[0][0] == 3 and got[0][1] == 40 and got[0][2] < 60
    # The zero-norm row scores exactly 0 for every feature.
    only_zero = np.where(np.arange(n) == 10, 0.0, -1.0).astype(np.float32)
    idx, best = _port(feats, gallery, only_zero, layout)
    assert (idx == 10).all() and (best == 0.0).all()


def test_first_occurrence_ties_across_tiles_like_jax(rng):
    k = 8
    feats = rng.normal(0, 1, (8, k)).astype(np.float32)
    gallery = rng.normal(0, 1, (32, k)).astype(np.float32)
    gallery[5] = feats[0] * 2.0
    gallery[21] = feats[0] * 4.0  # the same cosine, bit for bit, two tiles later
    gallery[9] = gallery[30] = feats[1]  # an exact duplicate in tiles 1 and 3
    gnorm = np.linalg.norm(gallery, axis=1).astype(np.float32)
    got = _port(feats, gallery, gnorm)
    _assert_same(got, _jax(feats, gallery, gnorm, tile_b=8, tile_n=8))
    assert got[0][0] == 5 and got[0][1] == 9


@pytest.mark.parametrize("layout", ["k_n", "rows"])
def test_bf16_operands_like_jax(rng, layout):
    """bf16 operands round the same way in both packages; the products of
    bf16 values are exact in float32, so only the order of sums differs."""
    b, k, n = 16, 32, 256
    feats = rng.normal(0, 1, (b, k)).astype(np.float32)
    gallery = rng.normal(0, 1, (n, k)).astype(np.float32)
    for i in range(b):
        gallery[i * 16] = feats[i]
    gnorm = np.linalg.norm(gallery, axis=1).astype(np.float32)
    got = _port(feats, gallery, gnorm, layout, operand_dtype=torch.bfloat16)
    _assert_same(got, _jax(feats, gallery, gnorm, tile_b=16, tile_n=64,
                           operand_dtype=jnp.bfloat16))
    np.testing.assert_array_equal(got[0], np.arange(b) * 16)
    # A bf16 gallery is read as it is: the same answer as rounding on the fly.
    g16 = torch.from_numpy(gallery).to(torch.bfloat16)
    idx, best = tgm.gallery_match(torch.from_numpy(feats), g16.T, torch.from_numpy(gnorm),
                                  operand_dtype=torch.bfloat16)
    np.testing.assert_array_equal(idx.numpy(), got[0])
    np.testing.assert_array_equal(best.numpy(), got[1])


@pytest.mark.parametrize("b,k,n", [(5, 12, 37), (3, 40, 131), (1, 7, 1)])
def test_ragged_b_and_n_like_jax(rng, b, k, n):
    feats = rng.normal(0, 1, (b, k)).astype(np.float32)
    gallery = rng.normal(0, 1, (n, k)).astype(np.float32)
    gallery[n - 1] = feats[0]  # a winner in the ragged last tile
    gnorm = np.linalg.norm(gallery, axis=1).astype(np.float32)
    got = _port(feats, gallery, gnorm)
    _assert_same(got, _jax(feats, gallery, gnorm, tile_b=8, tile_n=16))
    assert got[0][0] == n - 1


def test_zero_norm_feature_and_all_negative_cosines_like_jax(rng):
    """A zero-norm feature scores 0 on every valid row (the first one
    wins); a feature whose valid cosines are all negative still picks a
    valid row over the sentinel rows, zero vectors among them."""
    b, k, n = 4, 16, 40
    gallery = np.abs(rng.normal(0, 1, (n, k))).astype(np.float32)
    feats = -np.abs(rng.normal(0, 1, (b, k))).astype(np.float32)
    feats[1] = 0.0
    gallery[:4] = 0.0  # rows 0-3 are invalid zero vectors
    gnorm = np.linalg.norm(gallery, axis=1).astype(np.float32)
    gnorm[:4] = -1.0
    gnorm[30:] = -1.0
    got = _port(feats, gallery, gnorm)
    _assert_same(got, _jax(feats, gallery, gnorm, tile_b=8, tile_n=8))
    assert got[0][1] == 4 and got[1][1] == 0.0
    others = np.array([0, 2, 3])
    assert (got[1][others] < 0).all()
    assert ((got[0][others] >= 4) & (got[0][others] < 30)).all()


def test_all_rows_invalid_reports_row_0_at_minus_inf(rng):
    feats = rng.normal(0, 1, (3, 8)).astype(np.float32)
    gallery = rng.normal(0, 1, (20, 8)).astype(np.float32)
    gnorm = np.full(20, -1.0, np.float32)
    got = _port(feats, gallery, gnorm)
    _assert_same(got, _jax(feats, gallery, gnorm, tile_b=8, tile_n=8))
    assert (got[0] == 0).all() and np.isneginf(got[1]).all()


def _good_args(b=4, k=8, n=12):
    g = torch.Generator().manual_seed(0)
    return dict(
        feats=torch.randn(b, k, generator=g),
        gallery_t=torch.randn(n, k, generator=g).T,
        gallery_norm=torch.rand(n, generator=g),
    )


@pytest.mark.parametrize(
    "field,bad,exc",
    [
        ("feats", lambda a: a.double(), TypeError),
        ("gallery_t", lambda a: a.half(), TypeError),
        ("gallery_norm", lambda a: a.to(torch.bfloat16), TypeError),
        ("feats", lambda a: a.reshape(-1), ValueError),
        ("feats", lambda a: a[:, :-1].contiguous(), ValueError),  # k mismatch
        ("gallery_norm", lambda a: a[:-1], ValueError),
        ("gallery_t", lambda a: a[:, ::2], ValueError),  # neither layout
        ("feats", lambda a: a.T.contiguous().T, ValueError),  # not contiguous
        ("feats", lambda a: a[:0], ValueError),  # empty batch
    ],
)
def test_gallery_match_rejects_bad_args(field, bad, exc):
    args = _good_args()
    tgm.gallery_match(**args)  # the untouched arguments are accepted
    args[field] = bad(args[field])
    with pytest.raises(exc):
        tgm.gallery_match(**args)


def test_gallery_match_rejects_other_operand_dtypes():
    with pytest.raises(TypeError, match="operand_dtype"):
        tgm.gallery_match(**_good_args(), operand_dtype=torch.float16)


def test_gallery_match_counts_no_launch_on_cpu():
    before = tgm.gallery_match.launches
    args = _good_args()
    got = tgm.gallery_match(**args)
    want = tgm._gallery_match_plain(**args)
    assert tgm.gallery_match.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _view(layout, k, n, dtype, offset):
    """A gallery_t of (k, N) whose first element sits ``offset`` elements
    into a fresh buffer: for "rows" the ``.T`` of ``gallery[offset:]`` (a
    shard that starts at row ``offset``, ``offset * k`` elements in), for
    "k_n" a contiguous (k, N) cut from a flat buffer.  Returns the view
    and its element offset."""
    if layout == "rows":
        gallery = torch.zeros(n + offset, k, dtype=dtype)
        return gallery[offset:].T, offset * k
    buf = torch.zeros(offset + k * n, dtype=dtype)
    return buf[offset:].view(k, n), offset


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("layout", ["rows", "k_n"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [7, 8, 100, 128])
def test_fill16_takes_cp_async_only_where_every_row_is_16_byte_aligned(k, dtype, layout, offset):
    """The kernel may stage by 16-byte cp.async only when both operands
    start on 16 bytes and every row is a whole number of 16 bytes (the
    k of the features and of (N, k) rows, the N of a (k, N) gallery);
    ``sharded_gallery_match``'s ``gallery[start:stop].T`` is judged by its
    own base pointer."""
    n = 40
    gallery_t, elems = _view(layout, k, n, dtype, offset)
    feats = torch.zeros(3, k, dtype=dtype)
    assert tgm._gallery_rows(gallery_t) == (layout == "rows")
    size = torch.finfo(dtype).bits // 8
    assert feats.data_ptr() % 16 == 0 and (gallery_t.data_ptr() - elems * size) % 16 == 0
    want = (elems * size % 16 == 0 and k * size % 16 == 0
            and (layout == "rows" or n * size % 16 == 0))
    assert tgm._fill16(feats, gallery_t, layout == "rows") == want
    if offset == 3 and k == 128:  # a k = 128 shard at any row keeps cp.async
        assert want == (layout == "rows")


def test_fill16_judges_the_features_base_pointer_too():
    feats = torch.zeros(5, 128)
    gallery_t = torch.zeros(64, 128).T
    assert tgm._fill16(feats, gallery_t, True)
    assert not tgm._fill16(torch.zeros(5 * 128 + 1)[1:].view(5, 128), gallery_t, True)


def test_3xtf32_keeps_float32_parity_where_tf32_does_not():
    """The float32 path of the kernel, emulated: on large-gallery data
    (B 64, k 128, N 4096) its cosines lie within 1e-6 of float64 and its
    ids equal the Pallas kernel's; one TF32 pass misses by far more."""
    from face_detection_recognization_pca_tpu_torch import bench

    feats_t, gallery_t, _, planted = bench.large_gallery_assets(64, 128, 4096, 3,
                                                                torch.device("cpu"))
    feats, gallery = feats_t.numpy(), gallery_t.numpy()
    gnorm = np.linalg.norm(gallery, axis=1).astype(np.float32)
    frinv = (1.0 / np.linalg.norm(feats, axis=1)).astype(np.float32)
    grinv = (1.0 / gnorm).astype(np.float32)
    exact = (feats.astype(np.float64) @ gallery.T.astype(np.float64)
             / np.linalg.norm(feats.astype(np.float64), axis=1)[:, None]
             / np.linalg.norm(gallery.astype(np.float64), axis=1)[None, :])

    cos3 = dots_tf32(feats, gallery, 3) * frinv[:, None] * grinv[None, :]
    assert np.abs(cos3 - exact).max() <= 1e-6
    cos1 = dots_tf32(feats, gallery, 1) * frinv[:, None] * grinv[None, :]
    assert np.abs(cos1 - exact).max() > 1e-5

    ids, best = _jax(feats, gallery, gnorm, tile_b=64, tile_n=512)
    np.testing.assert_array_equal(np.argmax(cos3, axis=1), ids)
    np.testing.assert_array_equal(ids, planted)
    np.testing.assert_allclose(cos3.max(axis=1), best, rtol=0, atol=1e-6)
