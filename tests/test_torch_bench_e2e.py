"""Port parity for the end-to-end video bench (``bench_e2e_video``): the
port's ``bench.e2e_video`` against the JAX function on one small mp4, and
the file-free ``bench.e2e_frames`` against it.

The mp4 holds 48 frames of 180 x 240 from ``bench.haar_bgr_frames``, one
``bench.haar_face`` each, written with OpenCV (``mp4v``).  The JAX
function's Haar detector is ``tests/haar_scenes.ReplayDetector`` over the
port's ``HaarDetector`` on the CPU: a JAX ``HaarDetector`` compiles for
minutes per frame size.  Its fused NCC detector is its own.  Counts must be
equal; fps are clocks and are not compared."""

import tempfile

import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu import bench as jbench
from face_detection_recognization_pca_tpu_torch import bench as tbench
from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector
from haar_scenes import ReplayDetector, write_video

pytest.importorskip("cv2")
torch.set_num_threads(1)

CPU = torch.device("cpu")
N_FRAMES, SIZE, SEED, BATCH = 48, (180, 240), 3, 16
COUNTS = ("frames", "detected", "recognized", "recognition_rate")


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """The mp4's path and its frames as the decoder reads them back."""
    path = str(tmp_path_factory.mktemp("e2e") / "faces.mp4")
    frames, _ = tbench.haar_bgr_frames(N_FRAMES, SIZE, SEED, sides=(60, 100))
    return path, write_video(path, frames)


@pytest.fixture(scope="module")
def runs(video, tmp_path_factory):
    """The port's ``e2e_video`` and the JAX ``bench_e2e_video`` on the mp4,
    each writing its annotated videos into a directory of its own."""
    path, _ = video
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jbench._SHARED, "haar", ReplayDetector(HaarDetector(device=CPU)))
        for name, run in (("port", lambda: tbench.e2e_video(path, batch=BATCH, device=CPU)),
                          ("jax", lambda: jbench.bench_e2e_video(batch=BATCH, video=path))):
            mp.setattr(tempfile, "tempdir", str(tmp_path_factory.mktemp(name)))
            out[name] = run()
    return out


def test_e2e_video_has_the_jax_keys_and_counts(runs):
    """Both variants: the key set, the training crops and every count equal
    the JAX function's; every frame's face is found by the Haar variant."""
    got, want = runs["port"], runs["jax"]
    assert set(got) == set(want)
    assert got["e2e_train_crops"] == want["e2e_train_crops"] == N_FRAMES
    for variant in ("haar", "ncc"):
        for key in COUNTS:
            assert got[f"e2e_{variant}_{key}"] == want[f"e2e_{variant}_{key}"], (variant, key)
    assert got["e2e_haar_frames"] == got["e2e_haar_detected"] == N_FRAMES
    assert got["e2e_video"] == want["e2e_video"] == "faces.mp4"
    assert got["e2e_haar_fps"] > 0 and got["e2e_ncc_fps"] > 0


def test_e2e_video_writes_the_annotated_videos(runs):
    """Each variant's output is an mp4 of all frames, annotated as JAX's is:
    the two packages' outputs decode to the same frames."""
    from face_detection_recognization_pca_tpu_torch.io.video import VideoReader

    for variant in ("haar", "ncc"):
        decoded = []
        for name in ("port", "jax"):
            reader = VideoReader(runs[name][f"e2e_{variant}_output"])
            decoded.append(np.stack(list(reader.frames())))
            reader.close()
        assert decoded[0].shape == (N_FRAMES, *SIZE, 3)
        np.testing.assert_array_equal(decoded[0], decoded[1])


def test_e2e_frames_equals_e2e_video_on_the_decoded_frames(video, runs):
    """The file-free body on the decoded frames: the same counts, and the
    stages it leaves out listed."""
    _, frames = video
    got = tbench.e2e_frames(frames, batch=BATCH, device=CPU)
    want = runs["port"]
    assert set(got) == set(want) | {"e2e_left_out"}
    assert got["e2e_left_out"] == ["decode", "annotate", "encode"]
    assert got["e2e_train_crops"] == want["e2e_train_crops"]
    for variant in ("haar", "ncc"):
        for key in COUNTS:
            assert got[f"e2e_{variant}_{key}"] == want[f"e2e_{variant}_{key}"], (variant, key)
        assert got[f"e2e_{variant}_output"] is None
    assert got["e2e_native_ring"] is False


def test_e2e_skips_a_missing_file_and_too_few_crops(tmp_path):
    missing = str(tmp_path / "none.mp4")
    assert tbench.e2e_video(missing, device=CPU) == jbench.bench_e2e_video(video=missing) == {
        "e2e_skipped": f"{missing} not found"}
    noise = np.random.default_rng(0).integers(100, 120, (BATCH, *SIZE, 3), dtype=np.uint8)
    assert tbench.e2e_frames(noise, batch=BATCH, variants=("haar",), device=CPU) == {
        "e2e_skipped": "only 0 training crops"}


def test_e2e_frames_annotates_copies_and_runs_on_the_card_unless_told(video, monkeypatch):
    """With ``annotate`` and ``write`` given, the caller's frames stay as
    they were, and every frame reaches ``write`` once per variant; a call
    without ``device`` needs a card."""
    _, frames = video
    before = frames.copy()
    boxes, written = [], []
    got = tbench.e2e_frames(frames[:BATCH + 5], batch=BATCH, variants=("haar",),
                            annotate=lambda f, box, name, conf: boxes.append(box),
                            write=lambda label, f: written.append(label), device=CPU)
    np.testing.assert_array_equal(frames, before)
    assert got["e2e_left_out"] == ["decode"] and got["e2e_haar_frames"] == BATCH + 5
    assert len(boxes) == got["e2e_haar_detected"] and written == ["haar"] * (BATCH + 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.e2e_frames(frames, batch=BATCH)
