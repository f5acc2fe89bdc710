"""Port parity for the reference's flow, detect -> train -> recognize:
``run_pipeline`` of both packages on one synthetic mp4, and the port's
file-free ``run_pipeline_frames`` against its file form.

The JAX flow gets the port's Haar detections through
``haar_scenes.ReplayDetector``: a JAX ``HaarDetector`` call compiles for
minutes per frame size on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.pipeline import detect_app as jdetect
from face_detection_recognization_pca_tpu.pipeline import run_pipeline as jpipe
from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector
from face_detection_recognization_pca_tpu_torch.io import artifacts as tart
from face_detection_recognization_pca_tpu_torch.io import video as tvideo
from face_detection_recognization_pca_tpu_torch.pipeline import run_pipeline as tpipe
from haar_scenes import ReplayDetector, scene, write_video
from artifact_checks import listing as _listing, same_artifact as _same_artifact

torch.set_num_threads(1)

CPU = torch.device("cpu")


PIPE_PLANTS = [(20 + 3 * i, 40 + 9 * i, 64 + 2 * (i % 4), 1) for i in range(8)]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """An mp4 of eight 180 x 240 frames, each holding person 1's face, and
    the frames as the decoder reads them back."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(17)
    gray = np.stack([scene((180, 240), [p], (100, 8), rng) for p in PIPE_PLANTS])
    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    try:
        decoded = write_video(path, np.repeat(gray[..., None], 3, axis=3))
    except IOError as err:
        pytest.skip(f"OpenCV cannot write a video here: {err}")
    return path, decoded


def test_run_pipeline_matches_jax(clip, tmp_path, monkeypatch):
    """Both packages' flow on one mp4 from a working directory of their
    own: the same summary and the same files; the file-free body on the
    decoded frames gives the file form's records and model."""
    path, decoded = clip
    port_det = HaarDetector(device=CPU)
    monkeypatch.setattr(jdetect, "HaarDetector", lambda *a, **k: ReplayDetector(port_det))
    for name in ("t", "j"):
        os.makedirs(tmp_path / name)
    monkeypatch.chdir(tmp_path / "t")
    got = tpipe.run_pipeline("ann", video_path=path, device=CPU)
    monkeypatch.chdir(tmp_path / "j")
    want = jpipe.run_pipeline("ann", video_path=path)
    assert got == want
    assert got["faces_detected"] == len(PIPE_PLANTS) and got["recognitions"] == len(PIPE_PLANTS)
    assert _listing(tmp_path / "t") == _listing(tmp_path / "j")

    monkeypatch.chdir(tmp_path / "t")
    results = json.load(open("output/recognition_results.json"))["results"]
    frames = tpipe.run_pipeline_frames(list(decoded), tvideo.VideoMeta(240, 180, 25.0, 8), "ann",
                                       lock_dir=str(tmp_path / "f"), detector=port_det,
                                       video_path=path, device=CPU)
    assert frames["records"] == results
    assert sum(r["person_name"] == "ann" for r in results) >= 6
    _same_artifact(frames["artifact"], tart.load_model("faces/lock_version/ann/face_model.pkl"),
                   sign=False)
    assert sorted(os.listdir(tmp_path / "f" / "ann")) == [
        "ann_faces_detection.json", "ann_model_info.json", "face_model.pkl"]


def test_run_pipeline_enhanced_and_no_scan(clip, tmp_path, monkeypatch):
    path, _ = clip
    monkeypatch.chdir(tmp_path)
    out = tpipe.run_pipeline("ann", video_path=path, scan=False, enhanced=True, device=CPU)
    assert "recognitions" not in out and os.path.exists(out["enhanced_model_path"])
    from face_detection_recognization_pca_tpu.models.enhanced import load_enhanced

    assert load_enhanced(out["enhanced_model_path"]).labels.shape == (7 * len(PIPE_PLANTS),)
    with pytest.raises(ValueError, match="video_path"):
        tpipe.run_pipeline("ann", device=CPU)
