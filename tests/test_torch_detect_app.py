"""Port parity for the detection stage: ``detect_video`` and
``detect_video_v1`` of both packages on one short mp4 (written with
OpenCV) with the same detector results, and the file-free bodies
``detect_frames`` and ``detect_frames_v1`` on the frames in memory.

The JAX apps are handed a detector that replays the port's detections
(``haar_scenes.ReplayDetector``): the detectors themselves are held
against each other in ``test_torch_haar.py``, and a JAX detector call
costs minutes of XLA compiling per frame size."""

import json
import os

import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.io import checkpoint as jckpt
from face_detection_recognization_pca_tpu.pipeline import detect_app as japp
from face_detection_recognization_pca_tpu_torch.config import PipelineConfig
from face_detection_recognization_pca_tpu_torch.detect import haar as thaar
from face_detection_recognization_pca_tpu_torch.io import checkpoint as tckpt
from face_detection_recognization_pca_tpu_torch.io.detection_json import (
    read_detection_json,
    write_detection_json,
)
from face_detection_recognization_pca_tpu_torch.io.video import VideoMeta
from face_detection_recognization_pca_tpu_torch.pipeline import detect_app as tapp
from haar_scenes import VIDEO_PLANTS, ReplayDetector, video_frames, write_video

torch.set_num_threads(1)

N_FRAMES = len(VIDEO_PLANTS)
FACES_PER_FRAME = [1, 1, 2, 0, 1, 1]


@pytest.fixture(scope="module")
def detector():
    return thaar.HaarDetector(device="cpu")


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """``(path, frames as the decoder reads them back)``."""
    pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("video") / "clip.mp4")
    try:
        decoded = write_video(path, video_frames())
    except IOError as err:
        pytest.skip(f"OpenCV cannot write a video here: {err}")
    return path, decoded


def _record_fields(record):
    d = dict(vars(record))
    d["image_path"] = os.path.basename(d["image_path"])
    return d


def test_detect_video_matches_jax(video, detector, tmp_path):
    import cv2

    path, decoded = video
    got = tapp.detect_video(path, "ann", output_root=str(tmp_path / "t"), detector=detector)
    ref = japp.detect_video(path, "ann", output_root=str(tmp_path / "j"),
                            detector=ReplayDetector(detector))
    assert (got.video_path, got.total_frames, got.fps, got.total_faces_detected) == (
        ref.video_path, ref.total_frames, ref.fps, ref.total_faces_detected)
    assert got.total_frames == N_FRAMES and got.total_faces_detected == sum(FACES_PER_FRAME)
    assert [_record_fields(r) for r in got.faces] == [_record_fields(r) for r in ref.faces]
    assert [r.frame_number for r in got.faces] == [0, 1, 2, 2, 4, 5]
    assert [r.face_id for r in got.faces] == list(range(6))
    assert got.faces[3].image_filename == "face_000003_frame_000002.jpg"
    # The same files with the same pixels, and the JSON beside them.
    assert sorted(os.listdir(tmp_path / "t" / "ann")) == sorted(os.listdir(tmp_path / "j" / "ann"))
    for r in got.faces:
        a = cv2.imread(str(tmp_path / "t" / "ann" / r.image_filename))
        b = cv2.imread(str(tmp_path / "j" / "ann" / r.image_filename))
        assert a.shape == (r.height, r.width, 3)
        np.testing.assert_array_equal(a, b)
    file_t = json.load(open(tmp_path / "t" / "ann" / "ann_faces_detection.json"))
    file_j = json.load(open(tmp_path / "j" / "ann" / "ann_faces_detection.json"))
    assert list(file_t) == list(file_j)
    for f in (file_t, file_j):
        assert f.pop("processing_date")
        for face in f["faces"]:
            face["image_path"] = os.path.basename(face["image_path"])
    assert file_t == file_j
    # max_frames stops the decoder early in both.
    cut = tapp.detect_video(path, "cut", output_root=str(tmp_path / "t"), detector=detector,
                            max_frames=3)
    cut_j = japp.detect_video(path, "cut", output_root=str(tmp_path / "j"),
                              detector=ReplayDetector(detector), max_frames=3)
    assert cut.total_frames == cut_j.total_frames == 3
    assert [_record_fields(r) for r in cut.faces] == [_record_fields(r) for r in cut_j.faces]


@pytest.mark.parametrize("batch_frames", [1, 4])
def test_detect_frames_needs_no_file(video, detector, tmp_path, monkeypatch, batch_frames):
    """The body between the decoder and ``cv2.imwrite``: the records of
    ``detect_video`` (whose batch takes in the whole clip) with the frames
    taken one by one and four at a time, the raw BGR crops, and a JSON
    round trip."""
    path, decoded = video
    want = tapp.detect_video(path, "ann", output_root=str(tmp_path), detector=detector)
    monkeypatch.setattr(tapp, "DETECT_BATCH", batch_frames)
    meta = VideoMeta(240, 180, 25.0, N_FRAMES)
    det, crops = tapp.detect_frames(iter(decoded), meta, detector=detector, video_path=path,
                                    out_dir=str(tmp_path / "ann"))
    assert [vars(r) for r in det.faces] == [vars(r) for r in want.faces]
    assert det.total_frames == N_FRAMES and len(crops) == det.total_faces_detected == 6
    for r, crop in zip(det.faces, crops):
        np.testing.assert_array_equal(
            crop, decoded[r.frame_number][r.y:r.y + r.height, r.x:r.x + r.width])
        assert (r.center_x, r.center_y, r.area) == (
            r.x + r.width // 2, r.y + r.height // 2, r.width * r.height)
        assert r.timestamp == r.frame_number / 25.0
    write_detection_json(det, str(tmp_path / "round.json"))
    back = read_detection_json(str(tmp_path / "round.json"))
    assert [vars(r) for r in back.faces] == [vars(r) for r in det.faces]
    assert (back.total_frames, back.fps, back.video_path) == (N_FRAMES, 25.0, path)
    # A None frame ends the stream; without out_dir the path is the name.
    short, _ = tapp.detect_frames([decoded[0], None, decoded[1]], meta, detector=detector)
    assert short.total_frames == 1 and short.faces[0].image_path == short.faces[0].image_filename
    # With a sink every crop is handed over as it is found and none is kept:
    # by the time the frame after a face's is drawn from the iterator (here
    # with one frame per batch), the sink has that face.
    sunk = []
    seen_when_drawn = []

    def drawn():
        for frame in decoded:
            seen_when_drawn.append(len(sunk))
            yield frame

    if batch_frames == 1:
        streamed, kept = tapp.detect_frames(drawn(), meta, detector=detector,
                                            on_crop=lambda r, c: sunk.append((r, c.copy())))
        assert kept == [] and [r for r, _ in sunk] == streamed.faces
        assert seen_when_drawn == [0, 1, 2, 4, 4, 5]
        for (_, a), b in zip(sunk, crops):
            np.testing.assert_array_equal(a, b)


def test_detect_video_v1_matches_jax(video, detector, tmp_path):
    """Two runs into the same directories: the second resumes the ids."""
    import cv2

    path, decoded = video
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    for run in range(2):
        got = tapp.detect_video_v1(path, out_t, "ann", detector=detector)
        ref = japp.detect_video_v1(path, out_j, "ann", detector=ReplayDetector(detector))
        assert got.pop("detection_timestamp") and ref.pop("detection_timestamp")
        assert got == ref
        ids = [f["face_id"] for f in got["faces"]]
        assert ids == list(range(1 + 6 * run, 7 + 6 * run))
        assert [f["frame_number"] for f in got["faces"]] == [1, 2, 3, 3, 5, 6]  # from 1
        assert got["faces"][0]["filename"] == f"ann_face_{ids[0]:04d}.jpg"
        assert got["video_name"] == "clip.mp4" and got["person_name"] == "ann"
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    assert len([n for n in os.listdir(out_t) if n.endswith(".jpg")]) == 12
    for name in os.listdir(out_t):
        if name.endswith(".jpg"):
            a = cv2.imread(os.path.join(out_t, name))
            assert a.shape == (100, 100, 3)
            np.testing.assert_array_equal(a, cv2.imread(os.path.join(out_j, name)))
    # The metadata file and the resumable state, as the JAX app leaves them.
    meta_t = json.load(open(os.path.join(out_t, "clip_metadata.json")))
    meta_j = json.load(open(os.path.join(out_j, "clip_metadata.json")))
    assert meta_t.pop("detection_timestamp") and meta_j.pop("detection_timestamp")
    assert meta_t == meta_j
    state_t = tckpt.StageState.load(os.path.join(out_t, ".ann_detect_v1_state.json"))
    state_j = jckpt.StageState.load(os.path.join(out_j, ".ann_detect_v1_state.json"))
    assert vars(state_t) == vars(state_j)
    assert (state_t.stage, state_t.last_frame, state_t.next_face_id) == ("detect_v1", 5, 13)
    assert tapp.next_face_id(out_t, "ann") == japp.next_face_id(out_j, "ann") == 13
    assert tapp.next_face_id(out_t, "bob") == 1 and tapp.next_face_id(out_t + "_none", "ann") == 1
    # A deleted crop does not free its id: the state file remembers.
    os.remove(os.path.join(out_t, "ann_face_0012.jpg"))
    os.remove(os.path.join(out_j, "ann_face_0012.jpg"))
    again = tapp.detect_video_v1(path, out_t, "ann", detector=detector, max_frames=1)
    again_j = japp.detect_video_v1(path, out_j, "ann", detector=ReplayDetector(detector),
                                   max_frames=1)
    assert [f["face_id"] for f in again["faces"]] == [f["face_id"] for f in again_j["faces"]] == [13]


def test_detect_frames_v1_pads_clamps_and_resizes_as_opencv(video, detector):
    import cv2

    _, decoded = video
    cfg = PipelineConfig()
    metadata, crops, seen = tapp.detect_frames_v1(
        iter(decoded), "clip.mp4", "ann", starting_face_id=5, config=cfg, detector=detector)
    assert seen == N_FRAMES and len(crops) == len(metadata["faces"]) == 6
    assert [f["face_id"] for f in metadata["faces"]] == list(range(5, 11))
    clamped = 0
    for face, crop in zip(metadata["faces"], crops):
        frame = decoded[face["frame_number"] - 1]
        b = face["bbox"]
        x0, y0 = max(0, b["x"] - 20), max(0, b["y"] - 20)
        x1, y1 = min(240, b["x"] + b["width"] + 20), min(180, b["y"] + b["height"] + 20)
        clamped += (x1 - x0, y1 - y0) != (b["width"] + 40, b["height"] + 40)
        # The device resize equals cv2.resize bit for bit, BGR included.
        np.testing.assert_array_equal(crop, cv2.resize(frame[y0:y1, x0:x1], (100, 100)))
        assert face["face_size"] == {"width": 100, "height": 100}
    assert clamped >= 2  # the faces by the corner and by the border
    small, crops_small, _ = tapp.detect_frames_v1(
        iter(decoded[:1]), "clip.mp4", "ann", detector=detector, padding=0, crop_size=32)
    assert crops_small[0].shape == (32, 32, 3) and small["faces"][0]["face_id"] == 1
    # With a sink the crops go there, face entry by face entry.
    sunk = []
    again, kept, _ = tapp.detect_frames_v1(
        iter(decoded), "clip.mp4", "ann", starting_face_id=5, config=cfg, detector=detector,
        on_crop=lambda face, crop: sunk.append((face["filename"], crop)))
    assert kept == [] and [n for n, _ in sunk] == [f["filename"] for f in again["faces"]]
    for (_, a), b in zip(sunk, crops):
        np.testing.assert_array_equal(a, b)
