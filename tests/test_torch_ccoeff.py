"""Port parity for the CCOEFF template detector (``detect/ccoeff.py``) and
the ``fx`` form of the exact resize it uses, against the JAX package and
``cv2.resize`` on seeded frames.

The top-k of two FFTs that round differently can swap members that tie
to rounding at rank k, so every frame here is one where, for every
(scale, group), the k-th score exceeds the (k+1)-th by more than 1e-4 of
the largest |score|; the tests assert that gap first."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.detect import ccoeff as jcc
from face_detection_recognization_pca_tpu_torch import bench
from face_detection_recognization_pca_tpu_torch.detect import ccoeff as tcc
from face_detection_recognization_pca_tpu_torch.ops import dft_match as tdft
from face_detection_recognization_pca_tpu_torch.ops.match import _next_fast_len
from face_detection_recognization_pca_tpu_torch.ops.resize import resize_bilinear_u8_exact_scale

torch.set_num_threads(1)

GAP = 1e-4  # of the largest |score|
K = 6  # the fixtures' candidates per (scale, group): the gap holds there
SCORE_RTOL = 1e-4  # scores, of the largest |score|: float32 FFTs in two libraries


def _scene(size, seed=4):
    """Templates of two shape groups (three noisy 40 x 40 copies of person
    0's face, two 30 x 30 of person 1's) and a frame of noise ``90 + 8
    N(0, 1)`` holding both clean faces at seeded places: ``(templates,
    frame, [(x, y, side) planted])``."""
    rng = np.random.default_rng(seed)
    fa, fb = bench._person_face(0, 40), bench._person_face(1, 30)
    templates = [np.clip(f.astype(np.float32) + rng.normal(0, 6, f.shape), 0, 255).astype(np.uint8)
                 for f in (fa, fa, fa, fb, fb)]
    h, w = size
    frame = np.clip(rng.normal(90, 8, (h, w)), 0, 255).astype(np.uint8)
    ya, xa = rng.integers(0, h - 40), rng.integers(0, w - 40)
    frame[ya:ya + 40, xa:xa + 40] = fa
    yb, xb = rng.integers(0, h - 30), rng.integers(0, w - 30)
    frame[yb:yb + 30, xb:xb + 30] = fb
    return templates, frame, [(int(xa), int(ya), 40), (int(xb), int(yb), 30)]


def _assert_gap(det, frame, k):
    """Every (scale, group) of the detector's own top-k + 1 has the gap."""
    for _, _, _, vals, _, peak in det.topk(frame):
        assert vals[k - 1] - vals[k] > GAP * peak, "fixture lost its gap"


@pytest.mark.parametrize("size", [(544, 960), (137, 211), (180, 240), (1080, 1920)])
@pytest.mark.parametrize("scale", [0.5, 0.7, 1.3, 1.6])
def test_fx_resize_equals_cv2(size, scale):
    """``cv2.resize(img, None, fx=, fy=)`` bit for bit: OpenCV's output size
    (half to even) and source step 1/fx, and its INTER_AREA path for an
    exact 2x downscale (137 x 211 also has a column of half blocks)."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(size[0] + int(10 * scale)).integers(0, 256, size, dtype=np.uint8)
    want = cv2.resize(img, None, fx=scale, fy=scale)
    got = resize_bilinear_u8_exact_scale(torch.from_numpy(img), scale, scale).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_fx_resize_batches_and_odd_area_blocks():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (3, 103, 105), dtype=np.uint8)  # 51.5 -> 52 rows: a half row
    got = resize_bilinear_u8_exact_scale(torch.from_numpy(imgs), 0.5, 0.5).numpy()
    for img, g in zip(imgs, got):
        np.testing.assert_array_equal(g, cv2.resize(img, None, fx=0.5, fy=0.5))
    one = resize_bilinear_u8_exact_scale(torch.from_numpy(imgs[0]), 1.0, 1.0)
    assert torch.equal(one, torch.from_numpy(imgs[0]))


def test_ccoeff_topk_matches_jax():
    templates, frame, _ = _scene((217, 301))
    det = tcc.CcoeffTemplateDetector(templates, max_candidates=K, device="cpu")
    _assert_gap(det, frame, K)
    f = frame.astype(np.float32)
    size = (_next_fast_len(f.shape[0]), _next_fast_len(f.shape[1]))
    for (shape, t0), (jshape, jt0) in zip(det.groups, jcc.CcoeffTemplateDetector(templates).groups):
        assert shape == jshape
        np.testing.assert_array_equal(t0.numpy(), np.asarray(jt0))
        kf = torch.conj(torch.fft.rfft2(t0, s=size))
        vals, idx, peak = tcc._ccoeff_topk(torch.from_numpy(f), t0, K, kf)
        jvals, jidx = (np.asarray(a) for a in jcc._ccoeff_topk(jnp.asarray(f), jt0, K))
        np.testing.assert_allclose(vals.numpy(), jvals, rtol=0, atol=SCORE_RTOL * float(peak))
        np.testing.assert_array_equal(idx.numpy(), jidx)
        every, _, _ = tcc._ccoeff_topk(torch.from_numpy(f), t0, 10 ** 9, kf)
        assert float(peak) == float(every.abs().max())


def test_topk_order_is_descending_then_index():
    flat = torch.tensor([1.0, 5.0, 3.0, 5.0, 2.0, 5.0])
    vals, idx = tcc._ordered_topk(flat, 4)
    assert vals.tolist() == [5.0, 5.0, 5.0, 3.0] and idx.tolist() == [1, 3, 5, 2]


@pytest.mark.parametrize("size", [(217, 301), (320, 360)])
def test_detect_boxes_equal_jax(size):
    templates, frame, planted = _scene(size)
    det = tcc.CcoeffTemplateDetector(templates, max_candidates=K, device="cpu")
    assert len(det.groups) == 2
    _assert_gap(det, frame, K)
    got = det.detect(frame)
    assert got == jcc.CcoeffTemplateDetector(templates, max_candidates=K).detect(frame)
    assert det.detect_multi_scale(frame, 1.1, 5, (30, 30)) == got
    for x, y, side in planted:
        assert any(abs(b[0] - x) <= 3 and abs(b[1] - y) <= 3 and b[2] == side for b in got), got


def test_from_faces_dir_loads_ten_per_directory(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(2)
    sub = tmp_path / "faces" / "person_a"
    sub.mkdir(parents=True)
    for i in range(14):
        cv2.imwrite(str(sub / f"face_{i:02d}.jpg"), rng.integers(0, 256, (50, 50, 3), np.uint8))
    (tmp_path / "faces" / "readme.txt").write_text("not a directory")
    det = tcc.CcoeffTemplateDetector.from_faces_dir(str(tmp_path / "faces"), device="cpu")
    ref = jcc.CcoeffTemplateDetector.from_faces_dir(str(tmp_path / "faces"))
    assert det.n_templates == 10
    for (shape, t0), (jshape, jt0) in zip(det.groups, ref.groups):
        assert shape == jshape
        np.testing.assert_array_equal(t0.numpy(), np.asarray(jt0))
    with pytest.raises(ValueError, match="no templates"):
        tcc.CcoeffTemplateDetector.from_faces_dir(str(sub), device="cpu")


def test_scan_dual_with_ccoeff_detector_matches_jax(tmp_path):
    """``scan_dual(detector=CcoeffTemplateDetector)`` on a synthetic mp4,
    with a model from ``train_v1_version``: both packages, each with its
    own detector, count the same frames detected and recognized."""
    cv2 = pytest.importorskip("cv2")
    from face_detection_recognization_pca_tpu.pipeline import v1_apps as jv1
    from face_detection_recognization_pca_tpu_torch.pipeline import v1_apps as tv1
    from haar_scenes import write_video

    face = bench._person_face(0, 60)
    rng = np.random.default_rng(8)
    stills = tmp_path / "stills"
    stills.mkdir()
    for i in range(6):
        still = np.clip(face.astype(float) + rng.normal(0, 4, face.shape), 0, 255)
        cv2.imwrite(str(stills / f"ann_face_{i:04d}.jpg"), still.astype(np.uint8))
    model = tv1.train_v1_version(str(stills), "ann", str(tmp_path / "models"), "light",
                                 n_components=4, device="cpu")
    frames = []
    for i in range(3):
        gray = np.clip(rng.normal(90, 8, (180, 240)), 0, 255).astype(np.uint8)
        gray[40 + 5 * i:100 + 5 * i, 60 + 7 * i:120 + 7 * i] = face
        frames.append(np.repeat(gray[..., None], 3, axis=2))
    path = str(tmp_path / "planted.mp4")
    try:
        write_video(path, np.stack(frames), fps=10.0)
    except IOError as err:
        pytest.skip(f"OpenCV cannot write a video here: {err}")
    templates = [face]
    got = tv1.scan_dual(path, [model], str(tmp_path / "t"), max_frames=3, device="cpu",
                        detector=tcc.CcoeffTemplateDetector(templates, max_candidates=8,
                                                            device="cpu"))
    ref = jv1.scan_dual(path, [model], str(tmp_path / "j"), max_frames=3,
                        detector=jcc.CcoeffTemplateDetector(templates, max_candidates=8))
    assert got["counters"] == ref["counters"]
    assert got["counters"]["frames"] == got["counters"]["frames_with_detection"] == 3
    assert os.path.exists(got["output_video"])


def test_circular_correlator_defaults_to_the_cuda_device():
    """``device=None`` means the card, as at every entry point of the port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdft.make_circular_correlator(np.ones((4, 4), np.float32), 16, 13)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcc.CcoeffTemplateDetector([np.ones((4, 4), np.uint8)])
