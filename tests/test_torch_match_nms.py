"""Port parity: ``ops/integral.py``, ``ops/match.py``, ``ops/nms.py`` and
``ops/dft_match.dft_correlate_valid`` against the JAX package on the same
numpy inputs (the suite runs JAX with x64 on)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.ops import dft_match as jdft
from face_detection_recognization_pca_tpu.ops import integral as jint
from face_detection_recognization_pca_tpu.ops import match as jmatch
from face_detection_recognization_pca_tpu.ops import nms as jnms
from face_detection_recognization_pca_tpu_torch.ops import dft_match as tdft
from face_detection_recognization_pca_tpu_torch.ops import integral as tint
from face_detection_recognization_pca_tpu_torch.ops import match as tmatch
from face_detection_recognization_pca_tpu_torch.ops import nms as tnms

torch.set_num_threads(1)


def _planted(dtype, frame_hw=(70, 90), tpl_hw=(12, 17), at=(31, 44), seed=0):
    """A noise frame with a structured template written at ``at`` (y, x)."""
    rng = np.random.default_rng(seed)
    th, tw = tpl_hw
    yy, xx = np.mgrid[0:th, 0:tw] / max(th, tw)
    tpl = 120 + 60 * np.sin(9 * yy) + 40 * np.cos(7 * xx) + rng.normal(0, 4, (th, tw))
    frame = rng.uniform(40, 200, frame_hw)
    frame[at[0]:at[0] + th, at[1]:at[1] + tw] = tpl
    return frame.astype(dtype), tpl.astype(dtype)


def test_integral_and_window_moments_match_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (2, 19, 23))
    ref = np.asarray(jint.integral_image(jnp.asarray(img)))
    got = tint.integral_image(torch.from_numpy(img))
    assert got.shape == (2, 20, 24) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)
    np.testing.assert_allclose(
        tint.window_sums(got, (5, 7)).numpy(),
        np.asarray(jint.window_sums(jnp.asarray(ref), (5, 7))), rtol=1e-12,
    )
    mean_ref, var_ref = jint.window_mean_var(jnp.asarray(img.astype(np.float32)), (5, 7))
    mean, var = tint.window_mean_var(torch.from_numpy(img.astype(np.float32)), (5, 7))
    # float32 prefix sums up to 19 * 23 * 255^2 summed in other orders.
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_ref), rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_ref), rtol=1e-3, atol=0.5)


@pytest.mark.parametrize("method", ["direct", "fft"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ccoeff_normed_matches_jax(method, dtype):
    frame, tpl = _planted(dtype)
    ref = np.asarray(jmatch.match_template_ccoeff_normed(jnp.asarray(frame), jnp.asarray(tpl), method))
    got = tmatch.match_template_ccoeff_normed(torch.from_numpy(frame), torch.from_numpy(tpl), method)
    assert got.shape == ref.shape == (59, 74)
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    # float64 with a float64 numerator agrees to 1e-9.  The fft route takes
    # its transforms in float32 in both packages whatever the frame's
    # dtype, and float32 sums run in other orders: 1e-4 there.
    atol = 1e-9 if (dtype == np.float64 and method == "direct") else 1e-4
    np.testing.assert_allclose(got.numpy(), ref, atol=atol)
    score, loc = tmatch.min_max_loc(got)
    score_ref, loc_ref = jmatch.min_max_loc(jnp.asarray(ref))
    assert loc.tolist() == np.asarray(loc_ref).tolist() == [44, 31]  # (x, y)
    assert float(score) == pytest.approx(float(score_ref), abs=atol)
    assert float(score) > 0.99


def test_ccoeff_auto_route_and_match_best():
    # 12 * 17 <= 32 * 32 goes direct; 40 * 40 goes through the fft.
    small = _planted(np.float32)
    big = _planted(np.float32, (110, 120), (40, 40), (20, 60), seed=2)
    for (frame, tpl), method in ((small, "direct"), (big, "fft")):
        f, t = torch.from_numpy(frame), torch.from_numpy(tpl)
        np.testing.assert_array_equal(
            tmatch.match_template_ccoeff_normed(f, t).numpy(),
            tmatch.match_template_ccoeff_normed(f, t, method).numpy(),
        )
    score, loc = tmatch.match_best(torch.from_numpy(big[0]), torch.from_numpy(big[1]))
    score_ref, loc_ref = jmatch.match_best(jnp.asarray(big[0]), jnp.asarray(big[1]))
    assert loc.tolist() == np.asarray(loc_ref).tolist() == [60, 20]
    assert float(score) == pytest.approx(float(score_ref), abs=1e-4)


@pytest.mark.parametrize("method", ["direct", "fft"])
def test_ccoeff_unnormalized_matches_jax(method):
    frame, tpl = _planted(np.float32)
    ref = np.asarray(jmatch.match_template_ccoeff(jnp.asarray(frame), jnp.asarray(tpl), method))
    got = tmatch.match_template_ccoeff(torch.from_numpy(frame), torch.from_numpy(tpl), method)
    # Sums of 204 products of magnitudes up to 200 * 100, in float32.
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3 * np.abs(ref).max())
    assert int(got.argmax()) == int(ref.argmax())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_flat_windows_score_zero(dtype):
    frame, tpl = _planted(dtype)
    frame[:30, :40] = 77.0  # windows wholly inside are flat
    got = tmatch.match_template_ccoeff_normed(torch.from_numpy(frame), torch.from_numpy(tpl), "direct")
    ref = np.asarray(jmatch.match_template_ccoeff_normed(jnp.asarray(frame), jnp.asarray(tpl), "direct"))
    flat = got[: 30 - 12 + 1, : 40 - 17 + 1]
    assert torch.all(flat == 0)
    np.testing.assert_array_equal(got.numpy() == 0, ref == 0)


def test_min_max_loc_ties_give_the_first():
    scores = np.zeros((5, 7), np.float32)
    scores[1, 4] = scores[1, 5] = scores[3, 0] = 0.5
    val, loc = tmatch.min_max_loc(torch.from_numpy(scores))
    val_ref, loc_ref = jmatch.min_max_loc(jnp.asarray(scores))
    assert loc.tolist() == np.asarray(loc_ref).tolist() == [4, 1]
    assert float(val) == float(val_ref) == 0.5


def test_next_fast_len_matches_jax():
    for n in list(range(1, 70)) + [151, 453, 680, 1080, 1350, 1920, 2400]:
        assert tmatch._next_fast_len(n) == jmatch._next_fast_len(n)


def test_dft_correlate_valid_matches_jax_and_rfft():
    rng = np.random.default_rng(4)
    frames = rng.uniform(0, 255, (2, 36, 45)).astype(np.float32)
    kernels = rng.normal(0, 30, (3, 9, 11)).astype(np.float32)
    out_h, out_w = 28, 35
    ref = np.asarray(jdft.dft_correlate_valid(jnp.asarray(frames), jnp.asarray(kernels), out_h, out_w))
    got = tdft.dft_correlate_valid(torch.from_numpy(frames), torch.from_numpy(kernels), out_h, out_w)
    assert got.shape == ref.shape == (2, 3, out_h, out_w)
    # 1e-3 of the largest value: float32 DFT matmuls over 36 * 45 terms.
    tol = 1e-3 * np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, atol=tol)
    for b in range(2):
        for t in range(3):
            fft = tmatch._xcorr_fft(torch.from_numpy(frames[b]), torch.from_numpy(kernels[t]))
            np.testing.assert_allclose(got[b, t].numpy(), fft.numpy(), atol=tol)


def _random_boxes(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 60, (n, 2))
    wh = rng.integers(10, 40, (n, 2))
    return np.concatenate([xy, wh], axis=1).astype(np.float64), rng.uniform(0.1, 1.0, n)


def _both_masks(boxes, scores, **kw):
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    return {
        "nms": (tnms.nms(b, s, **kw).numpy(), np.asarray(jnms.nms(boxes, scores, **kw))),
        "cv2": (
            tnms.nms_boxes_cv2(b, s, 0.3, kw.get("overlap_threshold", 0.3)).numpy(),
            np.asarray(jnms.nms_boxes_cv2(boxes, scores, 0.3, kw.get("overlap_threshold", 0.3))),
        ),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_masks_match_jax_on_random_boxes(seed):
    boxes, scores = _random_boxes(24, seed)
    scores[5] = jnms.NEG_INF  # an empty slot
    np.testing.assert_allclose(
        tnms.iou_matrix(torch.from_numpy(boxes).float()).numpy(),
        np.asarray(jnms.iou_matrix(jnp.asarray(boxes, jnp.float32))), atol=1e-6,
    )
    for name, (got, ref) in _both_masks(boxes, scores).items():
        np.testing.assert_array_equal(got, ref, err_msg=name)
        assert 0 < got.sum() < 24
    assert not _both_masks(boxes, scores)["nms"][0][5]


def test_nms_equal_scores_keep_the_lowest_index():
    box = [10.0, 10.0, 20.0, 20.0]
    boxes = np.array([box, box, [50, 50, 20, 20], box], np.float64)
    scores = np.array([0.7, 0.7, 0.7, 0.7])
    for name, (got, ref) in _both_masks(boxes, scores).items():
        np.testing.assert_array_equal(got, ref, err_msg=name)
        assert got.tolist() == [True, False, True, False]


def test_nms_at_the_threshold_exactly():
    # Intersection 20 * 20 = 400 over union 2 * 600 - 400 = 800: IoU 0.5,
    # exact in float32.
    boxes = np.array([[0, 0, 20, 30], [0, 10, 20, 30]], np.float64)
    scores = np.array([0.9, 0.8])
    assert float(tnms.iou_matrix(torch.from_numpy(boxes))[0, 1]) == 0.5
    masks = _both_masks(boxes, scores, overlap_threshold=0.5)
    np.testing.assert_array_equal(*masks["nms"])
    np.testing.assert_array_equal(*masks["cv2"])
    assert masks["nms"][0].tolist() == [True, False]  # >= suppresses
    assert masks["cv2"][0].tolist() == [True, True]  # > does not
    # The strict score gate of NMSBoxes: a score equal to the threshold drops.
    got = tnms.nms_boxes_cv2(torch.from_numpy(boxes), torch.tensor([0.9, 0.3]), 0.3, 0.9)
    ref = np.asarray(jnms.nms_boxes_cv2(boxes, np.array([0.9, 0.3]), 0.3, 0.9))
    assert got.tolist() == ref.tolist() == [True, False]


@pytest.mark.parametrize("dtype", [np.float64, np.int64])
@pytest.mark.parametrize("frame", [(1920, 1080), (961, 545), (640, 360)])
def test_in_border_or_corner_matches_jax(dtype, frame):
    fw, fh = frame
    rng = np.random.default_rng(fw)
    n = 400
    boxes = np.stack(
        [rng.integers(0, fw - 20, n), rng.integers(0, fh - 20, n),
         rng.integers(11, 200, n), rng.integers(11, 200, n)], axis=1,
    )
    # Boxes that sit exactly on the strips' and squares' edges.
    bw, bh, cw, ch = int(fw * 0.05), int(fh * 0.05), int(fw * 0.15), int(fh * 0.15)
    edges = [[bw, bh, 50, 51], [bw - 1, bh, 50, 51], [fw - bw - 50, bh, 50, 51],
             [fw - bw - 49, bh, 50, 51], [cw - 25, ch - 25, 50, 51], [cw - 26, ch - 26, 51, 51]]
    boxes = np.concatenate([boxes, np.array(edges)]).astype(dtype)
    ref = np.asarray(jnms.in_border_or_corner(jnp.asarray(boxes), fw, fh))
    got = tnms.in_border_or_corner(torch.from_numpy(boxes), fw, fh).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < len(boxes)
