"""Port parity for the slice as a whole: one temporary lock directory
(v2 model pickles, detection JSONs and template JPEGs, written with the
JAX package's writers and OpenCV) and one short mp4 go through both
packages' ``scan_video_guided``, ``scan_live_guided``, ``scan_multimodel``
and ``scan_multimodel_batched``; and a second lock directory and an mp4 of
synthetic faces that the Haar cascade accepts go through both packages'
``scan_haar_multimodel``, the JAX app with a detector that replays the
port's detections."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.detect import haar as jhaar
from face_detection_recognization_pca_tpu.detect import template as jtpl
from face_detection_recognization_pca_tpu.io import artifacts as jart
from face_detection_recognization_pca_tpu.io import detection_json as jdet
from face_detection_recognization_pca_tpu.models import eigenfaces as jef
from face_detection_recognization_pca_tpu.ops import preprocess as jpre
from face_detection_recognization_pca_tpu.pipeline import scan_app as jscan
from face_detection_recognization_pca_tpu.recognize import engine as jengine
from face_detection_recognization_pca_tpu_torch.config import PipelineConfig
from face_detection_recognization_pca_tpu_torch.detect import haar as thaar
from face_detection_recognization_pca_tpu_torch.detect import template as ttpl
from face_detection_recognization_pca_tpu_torch.io.video import VideoReader, VideoWriter
from face_detection_recognization_pca_tpu_torch.pipeline import detect_app as tdetect_app
from face_detection_recognization_pca_tpu_torch.pipeline import scan_app as tscan
from face_detection_recognization_pca_tpu_torch.recognize import engine as tengine
from face_detection_recognization_pca_tpu_torch.utils import profiling
from haar_scenes import VIDEO_PLANTS, ReplayDetector, scene as haar_scene_frame, video_frames, \
    write_video

torch.set_num_threads(1)

CPU = torch.device("cpu")
SIZE, N_FRAMES, SIDE = (300, 400), 7, 96
# NCC values and cosines <= 1: float32 FFTs, window sums and projections
# summed in other orders.
FLOAT_ATOL = 1e-4


def _face(person, rng):
    yy, xx = np.mgrid[0:SIDE, 0:SIDE] / SIDE
    img = 128 + 55 * np.sin(6.28 * ((1.3 + person) * yy + 0.4 * person * xx)) \
        + 45 * np.cos(6.28 * (3.1 - person) * xx)
    return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """``(video, frames, lock, plants)``.  Person ``ann`` drifts through
    every frame but the last, which holds noise only; ``bob`` stands in
    frames 2 and 3 too, so those frames give two detections to arbitrate.
    Each person's directory holds a v2 model, template JPEGs and a
    detection JSON whose records sit at planted positions, 20 frames
    apart, so a guided scan of these few frames sees the first only (two
    priors that both cover the face tie to the last digit, and which of
    them wins is then rounding)."""
    cv2 = pytest.importorskip("cv2")
    h, w = SIZE
    rng = np.random.default_rng(17)
    faces = {"ann": _face(0, rng), "bob": _face(1, rng)}
    plants = {"ann": [(60 + 3 * i, 70 + 4 * i) for i in range(N_FRAMES - 1)],
              "bob": {2: (150, 260), 3: (152, 258)}}
    frames = rng.integers(70, 180, (N_FRAMES, h, w, 3)).astype(np.uint8)
    for i, (y, x) in enumerate(plants["ann"]):
        frames[i, y:y + SIDE, x:x + SIDE] = faces["ann"][..., None]
    for i, (y, x) in plants["bob"].items():
        frames[i, y:y + SIDE, x:x + SIDE] = faces["bob"][..., None]

    lock = tmp_path_factory.mktemp("faces") / "lock_version"
    lock.mkdir()
    for name, face in faces.items():
        pdir = lock / name
        pdir.mkdir()
        # Training rows: the face as the scan's preprocessing resizes it
        # to 32 x 32, rolled by up to 2 px with noise.
        row0 = np.asarray(jpre.preprocess_crops(jnp.asarray(face[None]), (32, 32)))[0]
        images = np.stack([
            np.roll(row0.reshape(32, 32), (rng.integers(-2, 3), rng.integers(-2, 3)), (0, 1))
            .reshape(-1) + rng.normal(0, 3, 32 * 32) for _ in range(20)
        ])
        images[0] = row0
        model, aux = jef.train_v2(jnp.asarray(images, jnp.float32),
                                  jnp.zeros(20, jnp.int32), 8, (32, 32))
        jart.save_model_v2(
            jef.to_artifact(model, aux, person_id_map={name: 0}, person_name=name),
            str(pdir / "face_model.pkl"))
        records = []
        spots = plants["ann"][:3] if name == "ann" else list(plants["bob"].values())
        for j, (y, x) in enumerate(spots):
            crop = np.clip(face + rng.normal(0, 4, face.shape), 0, 255).astype(np.uint8)
            fname = f"face_{j}_frame_{j}.jpg"
            assert cv2.imwrite(str(pdir / fname), crop)
            records.append(jdet.DetectionRecord(
                face_id=j, frame_number=20 * j, timestamp=20 * j / 25.0,
                x=x, y=y, width=SIDE, height=SIDE, center_x=x + SIDE // 2, center_y=y + SIDE // 2,
                area=SIDE * SIDE, image_path=f"faces\\lock_version\\{name}\\{fname}",
                image_filename=fname))
        jdet.write_detection_json(
            jdet.DetectionFile("training.mp4", 50, 25.0, len(records), "2024-01-02T03:04:05",
                               records),
            str(pdir / f"{name}_faces_detection.json"))

    video = str(tmp_path_factory.mktemp("video") / "scan.mp4")
    try:
        writer = VideoWriter(video, (w, h), 25.0)
    except IOError as err:
        pytest.skip(f"OpenCV cannot write a video here: {err}")
    for frame in frames:
        writer.write(frame)
    writer.close()
    return video, frames, str(lock), plants


def _assert_same_records(got, ref, atol=FLOAT_ATOL):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert list(a) == list(b)  # the same fields in the same order
        for key, value in a.items():
            assert type(value) is type(b[key]), key
            if isinstance(value, float):
                assert abs(value - b[key]) <= atol, (key, value, b[key])
            else:
                assert value == b[key], key


def test_loaders_hold_the_jax_loaders_arrays(scene):
    """A ``ModelStack`` and a ``TemplateBank`` read from the same files in
    both packages hold equal arrays."""
    _, _, lock, _ = scene
    jstack = jengine.ModelStack.from_lock_dir(lock)
    tstack = tengine.ModelStack.from_lock_dir(lock, device=CPU)
    assert tstack.model_names == jstack.model_names == ["ann", "bob"]
    for name in ("components", "projection_mean", "scaler_mean", "scaler_scale", "gallery",
                 "gallery_mask", "labels"):
        np.testing.assert_array_equal(getattr(tstack, name).numpy(),
                                      np.asarray(getattr(jstack, name)), err_msg=name)
    for persons in (None, {"bob"}):
        jbank = jtpl.TemplateBank.from_person_dirs(lock, persons=persons)
        tbank = ttpl.TemplateBank.from_person_dirs(lock, persons=persons, device=CPU)
        assert tbank.person_names == jbank.person_names
        assert [n for n, _ in tbank.entries] == [n for n, _ in jbank.entries]
        np.testing.assert_array_equal(tbank.canonical.numpy(), np.asarray(jbank.canonical))
        np.testing.assert_array_equal(tbank.native_ratios, jbank.native_ratios)
        np.testing.assert_array_equal(tbank.native_ratios, 0.75)
    assert len(tbank.entries) == 2 and len(jtpl.TemplateBank.from_person_dirs(lock).entries) == 5
    # per_person caps the templates read from each JSON.
    assert len(ttpl.TemplateBank.from_person_dirs(lock, per_person=1, device=CPU).entries) == 2


def test_template_bank_reads_with_opencv_where_the_native_library_is_absent(scene, monkeypatch):
    from face_detection_recognization_pca_tpu_torch.io import native

    _, _, lock, _ = scene
    with_native = ttpl.TemplateBank.from_person_dirs(lock, device=CPU)
    monkeypatch.setattr(native, "available", lambda: False)
    with_cv2 = ttpl.TemplateBank.from_person_dirs(lock, device=CPU)
    assert [t.shape for _, t in with_cv2.entries] == [(SIDE, SIDE)] * 5
    np.testing.assert_array_equal(with_cv2.canonical.numpy(), with_native.canonical.numpy())
    np.testing.assert_array_equal(with_cv2.native_ratios, with_native.native_ratios)


def test_scan_video_guided_matches_jax(scene, tmp_path):
    video, _, lock, plants = scene
    out_t = str(tmp_path / "t" / "recognition_output.mp4")
    out_j = str(tmp_path / "j" / "recognition_output.mp4")
    os.mkdir(tmp_path / "t"), os.mkdir(tmp_path / "j")
    got = tscan.scan_video_guided(video, "ann", lock_dir=lock, output_path=out_t, device=CPU)
    ref = jscan.scan_video_guided(video, "ann", lock_dir=lock, output_path=out_j)
    _assert_same_records(got, ref)
    # The prior of frame 0 serves frames 0..5 (tolerance 5); frame 6 has
    # none and gives no record.  The hits are the planted boxes.
    assert [r["frame_number"] for r in got] == list(range(N_FRAMES - 1))
    for r, (y, x) in zip(got, plants["ann"]):
        assert (r["x"], r["y"], r["width"], r["height"]) == (x, y, SIDE, SIDE)
        assert r["person_name"] == "ann" and r["person_id"] == 0 and r["confidence"] > 0.8
        assert r["ref_frame_diff"] == r["frame_number"]
    # The results file next to the video: the same layout and values.
    file_t = json.load(open(tmp_path / "t" / "recognition_results.json"))
    file_j = json.load(open(tmp_path / "j" / "recognition_results.json"))
    assert list(file_t) == list(file_j)
    assert file_t.pop("processing_date") and file_j.pop("processing_date")
    _assert_same_records(file_t.pop("results"), file_j.pop("results"))
    assert file_t == file_j and file_t["total_recognitions"] == N_FRAMES - 1
    # The annotated video was written with every frame.
    reader = VideoReader(out_t)
    assert reader.meta.frame_count == N_FRAMES
    reader.close()
    short = tscan.scan_video_guided(video, "ann", lock_dir=lock, max_frames=2, device=CPU,
                                    output_path=str(tmp_path / "short.mp4"))
    _assert_same_records(short, ref[:2])
    assert os.path.exists(tmp_path / "short_results.json")


def test_scan_live_guided_matches_jax(scene, tmp_path):
    _, frames, lock, plants = scene
    out = str(tmp_path / "live.mp4")
    got = tscan.scan_live_guided("ann", lock_dir=lock, frame_source=[f.copy() for f in frames],
                                 output_path=out, device=CPU)
    ref = jscan.scan_live_guided("ann", lock_dir=lock, frame_source=[f.copy() for f in frames])
    _assert_same_records(got, ref)
    # Frame-0 priors with a 2x window: the face is found while it stays
    # inside it, and the noise frame passes no hit above the live gate.
    assert [r["frame_number"] for r in got] == list(range(N_FRAMES - 1))
    for r, (y, x) in zip(got, plants["ann"]):
        assert (r["x"], r["y"]) == (x, y) and r["person_name"] == "ann"
        assert "timestamp" not in r and "ref_frame_diff" not in r
    assert os.path.getsize(out) > 0
    limited = tscan.scan_live_guided("ann", lock_dir=lock, frame_source=iter(frames),
                                     max_frames=3, device=CPU)
    _assert_same_records(limited, ref[:3])


@pytest.mark.parametrize("fused", [True, False])
def test_scan_multimodel_matches_jax(scene, tmp_path, fused):
    video, _, lock, plants = scene
    got = tscan.scan_multimodel(video, lock_dir=lock, fused_detector=fused, device=CPU,
                                output_path=str(tmp_path / "out.mp4"))
    ref = jscan.scan_multimodel(video, lock_dir=lock, fused_detector=fused)
    _assert_same_records(got, ref)
    assert got and all(r["person_name"] in ("ann", "bob", "unknown") for r in got)
    if fused:
        # One record per frame that holds a face (two detections in frames
        # 2 and 3 are arbitrated down to one), none for the noise frame.
        assert [r["frame_number"] for r in got] == list(range(N_FRAMES - 1))
        for r in got:
            y, x = plants["ann"][r["frame_number"]]
            spots = [(x, y)] + [(bx, by) for i, (by, bx) in plants["bob"].items()
                                if i == r["frame_number"]]
            # The frame is searched at 4/3 of its size (native ratio 0.75),
            # so a box maps back to within a pixel.
            near = [s for s in spots if abs(r["x"] - s[0]) <= 1 and abs(r["y"] - s[1]) <= 1]
            assert len(near) == 1
            assert r["template_confidence"] > 0.7 and r["pca_confidence"] > 0.8
            assert r["person_name"] == ("ann" if near[0] == (x, y) else "bob")


def test_scan_multimodel_batched_matches_jax_and_the_per_frame_scan(scene, tmp_path):
    video, frames, lock, _ = scene
    got = tscan.scan_multimodel_batched(video, lock_dir=lock, batch_frames=3, device=CPU,
                                        output_path=str(tmp_path / "out.mp4"))
    ref = jscan.scan_multimodel_batched(video, lock_dir=lock, batch_frames=3)
    _assert_same_records(got, ref)
    assert [r["frame_number"] for r in got] == list(range(N_FRAMES - 1))
    # Batched equals per-frame within the port (batches of 3, 3 and 1).
    per_frame = tscan.scan_multimodel(video, lock_dir=lock, device=CPU)
    _assert_same_records(got, per_frame)
    reader = VideoReader(str(tmp_path / "out.mp4"))
    assert reader.meta.frame_count == N_FRAMES
    reader.close()
    # max_frames cuts inside a batch, as in the JAX app.
    cut = tscan.scan_multimodel_batched(video, lock_dir=lock, batch_frames=3, max_frames=4,
                                        device=CPU)
    _assert_same_records(cut, jscan.scan_multimodel_batched(video, lock_dir=lock, batch_frames=3,
                                                            max_frames=4))
    assert [r["frame_number"] for r in cut] == [0, 1, 2, 3]


def test_batch_and_frame_iterator_forms_need_no_file(scene):
    """``scan_batches_multimodel`` and ``scan_frames_multimodel`` on frames
    in memory, with a stack and a bank built by the loaders: the same
    records either way, lists or stacks of frames, and the batched scan's
    stage spans."""
    _, frames, lock, plants = scene
    stack = tengine.ModelStack.from_lock_dir(lock, device=CPU)
    bank = ttpl.TemplateBank.from_person_dirs(lock, persons=set(stack.model_names), device=CPU)
    profiling.reset()
    profiling.enable(True)
    try:
        batched = tscan.scan_batches_multimodel([frames[:4], list(frames[4:])], stack, bank)
    finally:
        profiling.enable(False)
    traced = profiling.snapshot()
    profiling.reset()
    per_frame = tscan.scan_frames_multimodel(iter(frames), stack, bank)
    _assert_same_records(batched, per_frame)
    assert [r["frame_number"] for r in batched] == list(range(N_FRAMES - 1))
    for r in batched:
        assert r["person_name"] in ("ann", "bob") and r["width"] == SIDE
    stages = ("scan.upload_gray", "scan.detect_device", "scan.detect_select", "scan.verify",
              "scan.fuse")
    assert set(traced["totals"]) == set(stages) | {"scan.recognize"}
    assert all(traced["totals"][name][0] == 2 and traced["totals"][name][1] > 0
               for name in stages)
    # Every crop is recognized, the arbitration's losers too.
    assert traced["counters"]["scan.faces"] >= len(batched)
    assert tscan.scan_frames_multimodel([frames[0], None, frames[1]], stack, bank) == per_frame[:1]
    assert len(tscan.scan_batches_multimodel([frames[:4], frames[4:]], stack, bank,
                                             max_frames=5)) == 5


@pytest.fixture(scope="module")
def haar_scene(tmp_path_factory):
    """``(video, decoded frames, lock, detector)``: the clip of
    ``haar_scenes.video_frames`` and a lock directory with a v2 model each
    for ``ann`` (person 1's face) and ``bob`` (person 2's), trained on crops
    of their faces as the port's detector cuts them from training frames."""
    pytest.importorskip("cv2")
    video = str(tmp_path_factory.mktemp("haar_video") / "clip.mp4")
    try:
        decoded = write_video(video, video_frames())
    except IOError as err:
        pytest.skip(f"OpenCV cannot write a video here: {err}")
    detector = thaar.HaarDetector(device=CPU)
    rng = np.random.default_rng(41)
    lock = tmp_path_factory.mktemp("haar_faces") / "lock_version"
    lock.mkdir()
    for name, person in (("ann", 1), ("bob", 2)):
        rows = []
        for i in range(10):
            gray = haar_scene_frame((180, 240), [(15 + 4 * i, 40 + 6 * i, 60 + 3 * i, person)],
                                    (100, 8), rng)
            (x, y, w, h), = detector.detect_multi_scale(gray)
            crop = np.repeat(gray[y:y + h, x:x + w, None], 3, axis=2)
            rows.append(np.asarray(jpre.preprocess_crops(jnp.asarray(crop[None]), (32, 32)))[0])
        model, aux = jef.train_v2(jnp.asarray(np.stack(rows), jnp.float32),
                                  jnp.zeros(10, jnp.int32), 6, (32, 32))
        (lock / name).mkdir()
        jart.save_model_v2(
            jef.to_artifact(model, aux, person_id_map={name: 0}, person_name=name),
            str(lock / name / "face_model.pkl"))
    return video, decoded, str(lock), detector


def test_scan_haar_multimodel_matches_jax(haar_scene, tmp_path, monkeypatch):
    video, decoded, lock, detector = haar_scene
    got = tscan.scan_haar_multimodel(video, lock_dir=lock, device=CPU,
                                     output_path=str(tmp_path / "out.mp4"))
    monkeypatch.setattr(jhaar, "HaarDetector", lambda: ReplayDetector(detector))
    ref = jscan.scan_haar_multimodel(video, lock_dir=lock)
    # Cosines <= 1 of float32 projections summed in another order.
    _assert_same_records(got, ref, atol=1e-6)
    # A record per detected face, the frames' faces in the detector's order.
    assert [r["frame_number"] for r in got] == [0, 1, 2, 2, 4, 5]
    want_names = ["ann", "ann", "ann", "bob", "ann", "bob"]
    for r, name in zip(got, want_names):
        assert r["person_name"] in ("ann", "bob", "unknown")
        assert (r["person_id"] == 0) == (r["person_name"] != "unknown")
        if r["person_id"] == 0:
            assert r["confidence"] >= 0.7
    # The codec smooths the few grey levels that tell the persons apart, so
    # not every face is named right here (on clean frames each is: the chip
    # smoke test's pipeline phase holds that).
    assert sum(r["person_name"] == name for r, name in zip(got, want_names)) >= 3
    reader = VideoReader(str(tmp_path / "out.mp4"))
    assert reader.meta.frame_count == len(VIDEO_PLANTS)
    reader.close()
    cut = tscan.scan_haar_multimodel(video, lock_dir=lock, max_frames=3, device=CPU)
    _assert_same_records(cut, jscan.scan_haar_multimodel(video, lock_dir=lock, max_frames=3),
                         atol=1e-6)
    assert [r["frame_number"] for r in cut] == [0, 1, 2, 2]


@pytest.mark.parametrize("batch_frames", [1, 4])
def test_scan_frames_haar_multimodel_needs_no_file(haar_scene, monkeypatch, batch_frames):
    """The body after the decoder, on frames in memory with a stack built
    by the loader: the file form's records (its batch takes in the whole
    clip), with the frames taken one by one and four at a time."""
    video, decoded, lock, detector = haar_scene
    want = tscan.scan_haar_multimodel(video, lock_dir=lock, device=CPU)
    stack = tengine.ModelStack.from_lock_dir(lock, device=CPU)
    monkeypatch.setattr(tdetect_app, "DETECT_BATCH", batch_frames)
    got = tscan.scan_frames_haar_multimodel(iter(decoded), stack, detector=detector)
    _assert_same_records(got, want, atol=1e-6)
    # With no detector given, one is built on the stack's device.
    assert tscan.scan_frames_haar_multimodel([decoded[0], None, decoded[1]], stack) == got[:1]
    cfg = PipelineConfig()
    one = dataclasses.replace(cfg, detect=dataclasses.replace(cfg.detect, max_detections=1))
    capped = tscan.scan_frames_haar_multimodel(iter(decoded), stack, one, detector=detector)
    assert [r["frame_number"] for r in capped] == [0, 1, 2, 4, 5]
