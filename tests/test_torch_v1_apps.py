"""Port parity for the v1 apps and the output oracle: ``train_v1_version``,
``scan_dual`` and ``oracle.scan_dual_records`` of both packages on the
same stills and the same short mp4, with the same detector results, and
the annotation extraction and agreement score on frames drawn by
``annotate.draw_v1_square``.

The JAX apps are handed a detector that replays the port's detections
(``haar_scenes.ReplayDetector``)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.io import artifacts as jart
from face_detection_recognization_pca_tpu.pipeline import oracle as joracle
from face_detection_recognization_pca_tpu.pipeline import v1_apps as jv1
from face_detection_recognization_pca_tpu_torch.config import PipelineConfig
from face_detection_recognization_pca_tpu_torch.detect import haar as thaar
from face_detection_recognization_pca_tpu_torch.io import artifacts as tart
from face_detection_recognization_pca_tpu_torch.io.video import VideoReader
from face_detection_recognization_pca_tpu_torch.pipeline import detect_app as tapp
from face_detection_recognization_pca_tpu_torch.pipeline import oracle as toracle
from face_detection_recognization_pca_tpu_torch.pipeline import v1_apps as tv1
from face_detection_recognization_pca_tpu_torch.utils import annotate
from haar_scenes import VIDEO_PLANTS, ReplayDetector, scene, video_frames, write_video

torch.set_num_threads(1)

CPU = torch.device("cpu")
N_FRAMES = len(VIDEO_PLANTS)
# Cosines of float64 projections; the two packages' eigenvectors agree to
# rounding and up to sign, which a cosine does not see.
CONF_ATOL = 1e-9


@pytest.fixture(scope="module")
def detector():
    return thaar.HaarDetector(device="cpu")


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("video") / "clip.mp4")
    try:
        decoded = write_video(path, video_frames())
    except IOError as err:
        pytest.skip(f"OpenCV cannot write a video here: {err}")
    return path, decoded


@pytest.fixture(scope="module")
def stills(tmp_path_factory, detector):
    """``faces/Dark_version`` and ``faces/Light_version``: 100 x 100 crops of
    person 1's face as the v1 detection stage cuts them, from dim and from
    bright frames."""
    cv2 = pytest.importorskip("cv2")
    base = tmp_path_factory.mktemp("faces")
    rng = np.random.default_rng(31)
    for sub, level in (("Dark_version", 70), ("Light_version", 120)):
        os.mkdir(base / sub)
        frames = []
        for i in range(7):
            gray = scene((180, 240), [(20 + 3 * i, 50 + 4 * i, 72 + 2 * i, 1)], (level, 8), rng)
            frames.append(np.repeat(gray[..., None], 3, axis=2))
        meta, crops, _ = tapp.detect_frames_v1(frames, "stills.mp4", "ann", detector=detector)
        assert len(crops) == 7
        for face, crop in zip(meta["faces"], crops):
            assert cv2.imwrite(str(base / sub / face["filename"]), crop)
    (base / "Dark_version" / "notes.txt").write_text("not an image")
    return str(base)


@pytest.fixture(scope="module")
def models(stills, tmp_path_factory):
    """(port's model paths, JAX package's model paths), dark then light."""
    out = tmp_path_factory.mktemp("models")
    got = tv1.train_v1_versions("ann", stills, str(out / "t"), n_components=5, device=CPU)
    ref = jv1.train_v1_versions("ann", stills, str(out / "j"), n_components=5)
    return got, ref


def test_train_v1_versions_match_jax(models, tmp_path):
    got, ref = models
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref] == [
        "ann_dark_pca_model.pkl", "ann_light_pca_model.pkl"]
    assert sorted(os.listdir(os.path.dirname(got[0]))) == sorted(os.listdir(os.path.dirname(ref[0])))
    for tp, jp in zip(got, ref):
        info_t = json.load(open(tp.replace("_pca_model.pkl", "_model_info.json")))
        info_j = json.load(open(jp.replace("_pca_model.pkl", "_model_info.json")))
        assert list(info_t) == list(info_j)
        assert info_t.pop("training_timestamp") and info_j.pop("training_timestamp")
        evr_t, evr_j = info_t.pop("explained_variance_ratio"), info_j.pop("explained_variance_ratio")
        np.testing.assert_allclose(evr_t, evr_j, rtol=1e-9)
        assert info_t == info_j
        assert (info_t["n_components"], info_t["face_dimensions"], info_t["n_training_images"]) == (
            5, 10000, 7)
        # Each package loads the other's pickle, and the arrays agree up
        # to the sign of a component.
        for loader in (tart.load_model, jart.load_model):
            a, b = loader(tp), loader(jp)
            assert a.schema == b.schema == "v1" and a.person_name == b.person_name == "ann"
            assert a.version == b.version and a.training_filenames == b.training_filenames
            assert tuple(a.face_shape) == tuple(b.face_shape) == (100, 100)
            np.testing.assert_allclose(a.mean_face, b.mean_face, rtol=1e-12)
            sign = np.sign(np.sum(a.components * b.components, axis=1))
            np.testing.assert_allclose(a.components * sign[:, None], b.components, atol=1e-8)
            np.testing.assert_allclose(a.features * sign[None, :], b.features, atol=1e-6)
    assert os.path.exists(os.path.join(os.path.dirname(got[0]), "ann_dark_eigenface_05.jpg"))
    with pytest.raises(ValueError, match="no images"):
        tv1.train_v1_version(str(tmp_path), "x", device=CPU)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_scan_dual_matches_jax(video, models, detector, tmp_path, which):
    """Both packages scan with either package's pickles: the same counters,
    and an annotated video of every frame."""
    path, _ = video
    paths = models[0] if which == "port" else models[1]
    cfg = PipelineConfig()  # the faces here are 50-90 px
    cfg = dataclasses.replace(cfg, recognize=dataclasses.replace(cfg.recognize,
                                                                 min_annotation_box=40))
    got = tv1.scan_dual(path, paths, str(tmp_path / "t"), config=cfg, detector=detector,
                        device=CPU)
    ref = jv1.scan_dual(path, paths, str(tmp_path / "j"), config=cfg,
                        detector=ReplayDetector(detector))
    assert got["counters"] == ref["counters"] and got["summary"] == ref["summary"]
    assert got["counters"]["frames"] == N_FRAMES
    assert got["counters"]["frames_with_detection"] == 5
    assert got["counters"].get("frames_recognized", 0) >= 2  # person 1 is enrolled
    assert os.path.basename(got["output_video"]).startswith("recognized_dual_clip_")
    reader = VideoReader(got["output_video"])
    assert reader.meta.frame_count == N_FRAMES
    reader.close()
    # With no detector given, one is built on the device asked for.
    short = tv1.scan_dual(path, paths, str(tmp_path / "s"), config=cfg, max_frames=2, device=CPU)
    assert short["counters"]["frames"] == 2


@pytest.mark.parametrize("batch", [None, 4])
def test_scan_dual_records_match_jax(video, models, detector, batch):
    """Per frame and pipelined in batches (the last one short): what would
    be drawn equals the JAX oracle's, and the similarities behind it are
    the same float64 numbers."""
    import cv2

    path, decoded = video
    kwargs = dict(max_frames=N_FRAMES, min_annotation_box=40, batch=batch)
    got = toracle.scan_dual_records(path, models[0], detector=detector, **kwargs)
    ref = joracle.scan_dual_records(path, models[0], detector=ReplayDetector(detector), **kwargs)
    assert len(got) == len(ref) == N_FRAMES
    assert [(a.boxes, a.recognized) for a in got] == [(a.boxes, a.recognized) for a in ref]
    assert [len(a.boxes) for a in got] == [1, 1, 2, 0, 1, 1]
    assert got == toracle.scan_dual_records(path, models[0], detector=detector, max_frames=N_FRAMES,
                                            min_annotation_box=40)
    # Squares are clipped to the frame, as cv2.rectangle draws them.
    for ann in got:
        for x, y, w, h in ann.boxes:
            assert 0 <= x and 0 <= y and x + w <= 240 and y + h <= 180
    # The recognizer on one crop: the same name and the same float64 cosine
    # whichever package's pickles it reads.
    gray = cv2.cvtColor(decoded[0], cv2.COLOR_BGR2GRAY)
    x, y, w, h = detector.detect_multi_scale(gray)[0]
    roi = gray[y:y + h, x:x + w]
    name_t, conf_t = toracle.DualRecognizerNp(models[0]).best_similarity(roi)
    name_j, conf_j = joracle.DualRecognizerNp(models[0]).best_similarity(roi)
    assert (name_t, conf_t) == (name_j, conf_j) and name_t == "ann" and conf_t > 0.8
    _, conf_other = toracle.DualRecognizerNp(models[1]).best_similarity(roi)
    assert abs(conf_other - conf_t) <= CONF_ATOL
    ann = toracle.decide_frame(gray, [(x, y, w, h), (0, 0, 0, 0)],
                               toracle.DualRecognizerNp(models[0]), min_annotation_box=40)
    ref_ann = joracle.decide_frame(gray, [(x, y, w, h), (0, 0, 0, 0)],
                                   joracle.DualRecognizerNp(models[0]), min_annotation_box=40)
    assert (ann.boxes, ann.recognized) == (ref_ann.boxes, ref_ann.recognized) == ([(x, y, w, h)], True)
    assert toracle.decide_frame(gray, [(x, y, w, h)], toracle.DualRecognizerNp(models[0])).boxes == []


def test_annotation_extraction_and_agreement_equal_jax(tmp_path):
    """Frames drawn as the v1 scanner draws them (a red square, a cyan
    label when recognized): both packages recover the same marks, and
    score the same agreement."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    drawn, truth = [], []
    for i, (box, name) in enumerate([((60, 50, 90, 90), "ann"), ((30, 40, 70, 70), "unknown"),
                                     (None, None), ((100, 60, 80, 100), "ann")]):
        frame = rng.integers(90, 130, (180, 240, 3)).astype(np.uint8)
        if box:
            annotate.draw_v1_square(frame, box, name, 0.91)
        drawn.append(frame)
        truth.append(toracle.FrameAnnotation([box] if box else [], name == "ann"))
    got = [toracle.extract_frame_annotations(f) for f in drawn]
    ref = [joracle.extract_frame_annotations(f) for f in drawn]
    assert [(a.boxes, a.recognized) for a in got] == [(a.boxes, a.recognized) for a in ref]
    assert [len(a.boxes) for a in got] == [1, 1, 0, 1]
    x, y, w, h = got[0].boxes[0]
    assert abs(x - 60) <= 3 and abs(y - 50) <= 3 and abs(w - 90) <= 4 and abs(h - 90) <= 4
    # Frame 3's box is 80 x 100: the square of side 100 about its centre.
    assert abs(got[3].boxes[0][2] - 100) <= 4
    for use in (True, False):
        score = toracle.score_agreement(got, truth, use_recognized=use)
        assert score == joracle.score_agreement(
            ref, [joracle.FrameAnnotation(t.boxes, t.recognized) for t in truth],
            use_recognized=use)
    assert score["frames"] == 4 and score["boxed_jaccard"] == 1.0 and score["mean_iou"] > 0.7
    assert toracle.score_agreement([], [])["boxed_jaccard"] == 1.0
    # The shipped-output finder, on a made-up output directory.
    os.makedirs(tmp_path / "output")
    for name in ("recognized_dual_test_20240101_000000.mp4", "recognized_test2_1.mp4", "x.txt"):
        (tmp_path / "output" / name).write_text("")
    for stem in ("test", "test2", "absent"):
        assert toracle.find_shipped_output(str(tmp_path), stem) == \
            joracle.find_shipped_output(str(tmp_path), stem)
    assert toracle.find_shipped_output(str(tmp_path), "test").endswith("dual_test_20240101_000000.mp4")
    assert toracle.find_shipped_output(str(tmp_path / "none"), "test") is None
