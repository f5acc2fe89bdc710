"""Port parity: ``detect/guided.py`` against the JAX package on one
planted frame and the same priors."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.detect import guided as jguided
from face_detection_recognization_pca_tpu.io import detection_json as jdet
from face_detection_recognization_pca_tpu_torch.detect import guided as tguided
from face_detection_recognization_pca_tpu_torch.io import detection_json as tdet

torch.set_num_threads(1)

CPU = torch.device("cpu")
# NCC values <= 1 from float32 sums in other orders.
CONF_ATOL = 1e-5


def _scene(seed=5):
    """A 200 x 260 noise frame with a 40 x 40 face at (y, x) = (70, 90) and
    another copy, dimmed, that the right edge cuts at x = 236; and the
    template, a 50 x 50 version of the face that the matcher resizes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:50, 0:50] / 50
    template = np.clip(130 + 60 * np.sin(7 * yy) + 50 * np.cos(5 * xx) + rng.normal(0, 3, (50, 50)),
                       0, 255).astype(np.uint8)
    cv2 = pytest.importorskip("cv2")

    face = cv2.resize(template, (40, 40))
    frame = rng.integers(50, 200, (200, 260)).astype(np.uint8)
    frame[70:110, 90:130] = face
    frame[120:160, 236:260] = (face[:, :24] * 0.8).astype(np.uint8)
    return frame, template


def _prior(cx, cy, w, h, frame_number=None):
    fields = dict(center_x=cx, center_y=cy, width=w, height=h)
    if frame_number is not None:
        fields["frame_number"] = frame_number
    return types.SimpleNamespace(**fields)


def _same_hit(got, ref):
    assert (got is None) == (ref is None)
    if got is None:
        return
    assert list(got) == list(ref)
    for key in ("x", "y", "width", "height", "ref_frame_diff"):
        assert type(got[key]) is int and got[key] == ref[key], key
    assert type(got["confidence"]) is float
    assert abs(got["confidence"] - ref["confidence"]) <= CONF_ATOL


@pytest.mark.parametrize(
    "priors,expect_xy",
    [
        # One prior near the face: a 60 x 60 window, padded to 64.
        ([_prior(112, 88, 40, 40, 7)], (90, 70)),
        # Several: one far from any face, one near, one the frame's edge
        # clips (its window is 45 wide instead of 60); the near one wins.
        ([_prior(40, 150, 40, 40, 9), _prior(108, 92, 40, 40, 14), _prior(245, 140, 40, 40, 11)],
         (90, 70)),
        # Only the clipped prior: the hit lies inside the clipped window.
        ([_prior(245, 140, 40, 40, 11)], None),
        # A box larger than its clipped window, and an empty box: skipped.
        ([_prior(255, 195, 40, 40), _prior(100, 100, 0, 40)], "none"),
        # A window that needs no padding (64 x 64 exactly) and a non-square box.
        ([_prior(110, 90, 43, 43, 2), _prior(110, 90, 36, 44, 3)], None),
    ],
)
def test_match_frame_matches_jax(priors, expect_xy):
    frame, template = _scene()
    ref = jguided.GuidedMatcher(template, 1.5).match_frame(frame, priors, frame_number=10)
    got = tguided.GuidedMatcher(template, 1.5, device=CPU).match_frame(frame, priors,
                                                                        frame_number=10)
    _same_hit(got, ref)
    if expect_xy == "none":
        assert got is None
    elif expect_xy is not None:
        assert (got["x"], got["y"]) == expect_xy
        assert got["confidence"] > 0.9
    if got is not None and priors[0].center_x == 245:
        assert got["x"] + 40 <= 260 and got["ref_frame_diff"] == 1


def test_window_best_masks_the_padding():
    """The best score of a padded window never lies where the template
    would reach into the padding, even when the padding holds the face."""
    frame, template = _scene()
    cv2 = pytest.importorskip("cv2")

    face = cv2.resize(template, (40, 40)).astype(np.float32)
    window = np.pad(frame[60:120, 80:140].astype(np.float32), ((0, 44), (0, 44)), mode="edge")
    window[60:100, 60:100] = face  # an exact copy, wholly inside the padding
    conf, x, y = tguided._window_best(torch.from_numpy(window), torch.from_numpy(face), 60, 60)
    rconf, rx, ry = jguided._window_best(jnp.asarray(window), jnp.asarray(face), 60, 60)
    assert (int(x), int(y)) == (int(rx), int(ry)) == (10, 10)
    assert abs(float(conf) - float(rconf)) <= CONF_ATOL


def test_match_with_detection_file_matches_jax():
    frame, template = _scene()

    def det_file(mod):
        return mod.DetectionFile("v.mp4", 30, 25.0, 3, "2024-01-02T03:04:05", [
            mod.DetectionRecord(face_id=i, frame_number=fn, timestamp=fn / 25.0, x=cx - 20,
                                y=cy - 20, width=40, height=40, center_x=cx, center_y=cy,
                                area=1600, image_path="", image_filename="")
            for i, (fn, cx, cy) in enumerate([(3, 112, 88), (12, 108, 92), (40, 30, 30)])
        ])

    for frame_number, n_priors in ((10, 1), (5, 1), (25, 0), (8, 2)):
        ref = jguided.GuidedMatcher(template).match_with_detection_file(
            frame, det_file(jdet), frame_number, tolerance=5)
        got = tguided.GuidedMatcher(template, device=CPU).match_with_detection_file(
            frame, det_file(tdet), frame_number, tolerance=5)
        _same_hit(got, ref)
        assert (got is None) == (n_priors == 0)
