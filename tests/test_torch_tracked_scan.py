"""Port parity for the tracked-scan app: both packages'
``scan_video_tracked`` on one synthetic video file and one lock
directory, which the JAX package's own writers made; and the port's
batch-iterator form against the JAX app fed the same frames."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.io import artifacts as jart
from face_detection_recognization_pca_tpu.io import detection_json as jdet
from face_detection_recognization_pca_tpu.models import eigenfaces as jef
from face_detection_recognization_pca_tpu.pipeline import tracked_scan as jscan
from face_detection_recognization_pca_tpu_torch import bench as tbench
from face_detection_recognization_pca_tpu_torch import device as tdevice
from face_detection_recognization_pca_tpu_torch.io.video import VideoMeta, VideoReader, VideoWriter
from face_detection_recognization_pca_tpu_torch.pipeline import tracked_scan as tscan

torch.set_num_threads(1)

CPU = torch.device("cpu")
PERSON = "ann"
SIZE, N_FRAMES, BATCH = (400, 500), 10, 4  # the last batch is padded
INT_FIELDS = ("frame_number", "x", "y", "width", "height", "person_id", "ref_frame_diff")
FLOAT_FIELDS = ("timestamp", "confidence", "template_match_confidence")
# Float32 sums in other orders (the step's mean, the DFT matmuls, the
# projection); the scores are cosines and NCC values <= 1.
FLOAT_ATOL = 1e-5


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Frames with a drifting planted face, and a lock directory written
    by the JAX package: its v1 model pickle, its detection JSON, and the
    first crop as an image file."""
    cv2 = pytest.importorskip("cv2")  # the JAX app decodes and reads the crop with it
    h, w = SIZE
    rng = np.random.default_rng(11)
    face = np.clip(np.rint(tbench._planted_face(rng, 96)), 0, 255).astype(np.uint8)
    plants = np.array([(150 + i, 200 - 2 * i) for i in range(N_FRAMES)], np.int32)
    frames = rng.integers(60, 161, (N_FRAMES, h, w), dtype=np.uint8)
    for frame, (y, x) in zip(frames, plants):
        frame[y:y + 96, x:x + 96] = face
    images = tbench._gallery_images(rng, face.astype(np.float32), 24)
    jmodel, aux = jef.train_v1(jnp.asarray(images), n_components=8)

    lock = tmp_path_factory.mktemp("lock")
    person_dir = lock / PERSON
    person_dir.mkdir()
    jart.save_model_v1(jef.to_artifact(jmodel, aux, person_name=PERSON),
                       str(person_dir / "face_model.pkl"))
    crop = str(person_dir / "face_0_frame_2.png")
    assert cv2.imwrite(crop, face)
    y0, x0 = (int(v) for v in plants[0])
    jdet.write_detection_json(
        jdet.DetectionFile("training.mp4", 50, 25.0, 1, "2024-01-02T03:04:05", [
            jdet.DetectionRecord(
                face_id=0, frame_number=2, timestamp=0.08, x=x0, y=y0, width=96, height=96,
                center_x=x0 + 48, center_y=y0 + 48, area=96 * 96,
                # A path from another machine: only its basename is found.
                image_path="C:\\faces\\ann\\face_0_frame_2.png",
                image_filename="face_0_frame_2.png")]),
        str(person_dir / f"{PERSON}_faces_detection.json"))
    return frames, plants, face, str(lock)


def _assert_same_records(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert list(a) == list(b)  # the same fields in the same order
        for key in INT_FIELDS:
            assert type(a[key]) is int and a[key] == b[key], key
        assert a["person_name"] == b["person_name"]
        for key in FLOAT_FIELDS:
            assert type(a[key]) is float
            assert abs(a[key] - b[key]) <= FLOAT_ATOL, (key, a[key], b[key])


def test_scan_video_tracked_matches_jax_on_a_video_file(scene, tmp_path):
    frames, _, _, lock = scene
    video = str(tmp_path / "scan.mp4")
    try:
        writer = VideoWriter(video, (SIZE[1], SIZE[0]), 25.0)
    except IOError as err:
        pytest.skip(f"OpenCV cannot write a video here: {err}")
    for frame in frames:
        writer.write(np.repeat(frame[..., None], 3, axis=-1))
    writer.close()
    reader = VideoReader(video)
    assert (reader.meta.height, reader.meta.width) == SIZE
    assert reader.meta.frame_count == N_FRAMES and reader.meta.fps == 25.0
    reader.close()

    out_t, out_j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    got = tscan.scan_video_tracked(video, PERSON, lock_dir=lock, output_json=out_t, batch=BATCH,
                                   device=CPU)
    ref = jscan.scan_video_tracked(video, PERSON, lock_dir=lock, output_json=out_j, batch=BATCH)
    assert len(got) == N_FRAMES
    _assert_same_records(got, ref)
    assert [r["ref_frame_diff"] for r in got] == [2] + [1] * (N_FRAMES - 1)
    assert all(r["width"] == 96 for r in got)

    # The JSON files: the same layout, and the same values apart from the date.
    file_t, file_j = json.load(open(out_t)), json.load(open(out_j))
    assert list(file_t) == list(file_j)
    assert file_t.pop("processing_date") and file_j.pop("processing_date")
    _assert_same_records(file_t.pop("results"), file_j.pop("results"))
    assert file_t == file_j
    assert file_t["engine"] == "tracked-multistream" and file_t["total_frames"] == N_FRAMES

    # max_frames stops at a batch boundary, as in the JAX app.
    short = tscan.scan_video_tracked(video, PERSON, lock_dir=lock, batch=BATCH, max_frames=5,
                                     device=CPU)
    assert len(short) == len(jscan.scan_video_tracked(video, PERSON, lock_dir=lock, batch=BATCH,
                                                      max_frames=5)) == 8


class _FakeReader:
    """Stands in for the JAX app's ``VideoReader``: hands out given frames."""

    def __init__(self, frames, meta):
        self.frames, self.meta = frames, meta

    def batches(self, batch, gray=False):
        for i in range(0, len(self.frames), batch):
            stack = self.frames[i:i + batch]
            n = len(stack)
            if n < batch:
                stack = np.concatenate([stack, np.zeros((batch - n, *stack.shape[1:]), np.uint8)])
            yield stack, n

    def close(self):
        pass


@pytest.mark.parametrize("template", ["from_the_crop_file", "given"])
def test_scan_batches_tracked_matches_jax_and_finds_every_plant(scene, monkeypatch, template):
    """The same uint8 frames, no codec in between: the port's
    batch-iterator form against the JAX app, and both planted-exact."""
    frames, plants, face, lock = scene
    meta = VideoMeta(width=SIZE[1], height=SIZE[0], fps=25.0, frame_count=N_FRAMES)
    reader = _FakeReader(frames, meta)
    monkeypatch.setattr(jscan, "VideoReader", lambda path: reader)
    ref = jscan.scan_video_tracked("unused.mp4", PERSON, lock_dir=lock, batch=BATCH)
    got = tscan.scan_batches_tracked(
        reader.batches(BATCH), meta, PERSON, lock_dir=lock, device=CPU,
        template_full=face if template == "given" else None)
    _assert_same_records(got, ref)
    assert [(r["y"], r["x"]) for r in got] == [tuple(p) for p in plants.tolist()]
    assert all(r["person_id"] == 0 and r["person_name"] == PERSON for r in got)
    assert min(r["confidence"] for r in got) > 0.999
    assert [r["timestamp"] for r in got] == [i / 25.0 for i in range(N_FRAMES)]


def test_scan_sizes_follow_the_jax_arithmetic(scene, monkeypatch):
    """Explicit template and window sizes, and a frame too small for the
    default window: the same records from both packages."""
    frames, _, face, lock = scene
    small = np.ascontiguousarray(frames[:4, 100:260, 150:350])
    meta = VideoMeta(width=200, height=160, fps=0.0, frame_count=4)
    reader = _FakeReader(small, meta)
    monkeypatch.setattr(jscan, "VideoReader", lambda path: reader)
    for kwargs in ({}, {"template_side": 64, "window": 128}):
        ref = jscan.scan_video_tracked("unused.mp4", PERSON, lock_dir=lock, batch=2, **kwargs)
        got = tscan.scan_batches_tracked(reader.batches(2), meta, PERSON, lock_dir=lock,
                                         device=CPU, template_full=face, **kwargs)
        _assert_same_records(got, ref)
        assert got[0]["width"] == 64 and got[0]["timestamp"] == 0.0


def test_scan_computes_in_full_float32_and_restores_the_flags(scene):
    """With TF32 switched on by the caller, the scan's step still runs
    with both switches off, gives the same records, and puts them back."""
    frames, _, face, lock = scene
    meta = VideoMeta(width=SIZE[1], height=SIZE[0], fps=25.0, frame_count=4)
    reader = _FakeReader(frames[:4], meta)

    def scan():
        return tscan.scan_batches_tracked(reader.batches(2), meta, PERSON, lock_dir=lock,
                                          device=CPU, template_full=face)

    ref = scan()
    before = tdevice.tf32_flags()
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = scan()
        after = tdevice.tf32_flags()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before["matmul_allow_tf32"]
        torch.backends.cudnn.allow_tf32 = before["cudnn_allow_tf32"]
    assert got == ref
    assert after == {"matmul_allow_tf32": True, "cudnn_allow_tf32": True}


def test_scan_errors(scene, tmp_path, monkeypatch):
    frames, _, face, lock = scene
    meta = VideoMeta(width=SIZE[1], height=SIZE[0], fps=25.0, frame_count=1)
    with pytest.raises(IOError, match="cannot open video"):
        tscan.scan_video_tracked(str(tmp_path / "missing.mp4"), PERSON, lock_dir=lock, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscan.scan_batches_tracked(iter(()), meta, PERSON, lock_dir=lock, template_full=face)
    # A detection JSON without a usable crop.
    person_dir = tmp_path / "bo"
    person_dir.mkdir()
    os.link(os.path.join(lock, PERSON, "face_model.pkl"), person_dir / "face_model.pkl")
    jdet.write_detection_json(jdet.DetectionFile("t.mp4", 1, 25.0, 0, "", []),
                              str(person_dir / "bo_faces_detection.json"))
    with pytest.raises(ValueError, match="no usable template crop for bo"):
        tscan.scan_batches_tracked(iter(()), meta, "bo", lock_dir=str(tmp_path), device=CPU)
