"""Port parity for the apps: the training stage (``train_app``), the
accuracy harness (``eval_app``), the video helpers (``PrefetchingFeed``,
``record_camera``) and ``utils/profiling``, each against the JAX package
on the same files.  The reference's flow is in ``test_torch_pipeline.py``
and the command line in ``test_torch_cli.py``."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu import config as jconfig
from face_detection_recognization_pca_tpu.io import artifacts as jart
from face_detection_recognization_pca_tpu.models import eigenfaces as jef
from face_detection_recognization_pca_tpu.pipeline import eval_app as jeval
from face_detection_recognization_pca_tpu.pipeline import train_app as jtrain
from face_detection_recognization_pca_tpu_torch import bench
from face_detection_recognization_pca_tpu_torch.config import PipelineConfig
from face_detection_recognization_pca_tpu_torch.io import artifacts as tart
from face_detection_recognization_pca_tpu_torch.io import video as tvideo
from face_detection_recognization_pca_tpu_torch.io.detection_json import (
    DetectionFile,
    DetectionRecord,
    write_detection_json,
)
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as tef
from face_detection_recognization_pca_tpu_torch.pipeline import eval_app as teval
from face_detection_recognization_pca_tpu_torch.pipeline import train_app as ttrain
from face_detection_recognization_pca_tpu_torch.utils import profiling
from face_detection_recognization_pca_tpu_torch.utils.profiling import device_trace
from artifact_checks import listing as _listing, same_artifact as _same_artifact
from haar_scenes import video_frames, write_video

torch.set_num_threads(1)

CPU = torch.device("cpu")
CONF_ATOL = 1e-9


def _float64(cfg):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, dtype="float64"))


@pytest.fixture(scope="module")
def lock(tmp_path_factory):
    """A lock directory of two persons' BGR JPEG crops at three sizes:
    ``ann`` with a detection JSON, ``bob`` without one (training backfills
    it)."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("lock")
    rng = np.random.default_rng(21)
    for person, pid, n in (("ann", 1, 9), ("bob", 2, 7)):
        os.makedirs(root / person)
        records = []
        for i in range(n):
            side = (56, 72, 88)[i % 3]
            patch = bench.haar_face(side, pid).astype(np.float64)
            crop = np.clip(np.rint(patch + rng.normal(0, 4, patch.shape)), 0, 255).astype(np.uint8)
            name = f"face_{i:06d}_frame_{3 * i:06d}.jpg"
            path = str(root / person / name)
            assert cv2.imwrite(path, np.repeat(crop[..., None], 3, axis=2))
            h = crop.shape[0]
            records.append(DetectionRecord(i, 3 * i, 0.1 * i, 10, 20, h, h, 10 + h // 2,
                                           20 + h // 2, h * h, path, name))
        if person == "ann":
            write_detection_json(DetectionFile("v.mp4", 30, 30.0, n, "", records),
                                 str(root / person / f"{person}_faces_detection.json"))
    return str(root)


def test_train_single_person_matches_jax(lock, tmp_path):
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    shutil.copytree(lock, t)
    shutil.copytree(lock, j)
    got = ttrain.train_single_person("ann", t, _float64(PipelineConfig()), device=CPU)
    ref = jtrain.train_single_person("ann", j, _float64(jconfig.PipelineConfig()))
    _same_artifact(got, ref)
    assert got.n_components == 8
    assert _listing(t) == _listing(j)
    info_t = json.load(open(os.path.join(t, "ann", "ann_model_info.json")))
    info_j = json.load(open(os.path.join(j, "ann", "ann_model_info.json")))
    assert info_t.keys() == info_j.keys() and info_t["n_faces"] == info_j["n_faces"]
    for loader in (tart.load_model, jart.load_model):
        _same_artifact(loader(os.path.join(t, "ann", "face_model.pkl")), got, sign=False)


def test_train_all_persons_matches_jax(lock, tmp_path, monkeypatch):
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    shutil.copytree(lock, t)
    shutil.copytree(lock, j)
    monkeypatch.chdir(tmp_path)
    cfg_t = PipelineConfig()
    cfg_t = dataclasses.replace(cfg_t, paths=dataclasses.replace(cfg_t.paths, models_dir="mt"))
    cfg_j = jconfig.PipelineConfig()
    cfg_j = dataclasses.replace(cfg_j, paths=dataclasses.replace(cfg_j.paths, models_dir="mj"))
    got = ttrain.train_all_persons(t, cfg_t, device=CPU)
    ref = jtrain.train_all_persons(j, cfg_j)
    assert list(got) == list(ref) == ["ann", "bob", "multi_person"]
    for name in got:
        _same_artifact(got[name], ref[name])
    assert got["multi_person"].person_id_map == {"ann": 0, "bob": 1}
    assert _listing(t) == _listing(j) and _listing("mt") == _listing("mj")
    assert os.path.exists(os.path.join(t, "bob", "bob_faces_detection.json"))
    again = ttrain.train_all_persons(t, cfg_t, combined=False, save=False, device=CPU)
    assert list(again) == ["ann", "bob"]


def test_crop_vectors_batch_equals_one_by_one(lock):
    crops, _ = ttrain._load_person_crops(os.path.join(lock, "ann"), "ann")
    batch = ttrain.crop_vectors(crops, (64, 64), CPU)
    for i, crop in enumerate(crops):
        assert torch.equal(batch[i], ttrain.crop_vectors([crop], (64, 64), CPU)[0])


def test_evaluate_and_cross_lighting_match_jax(lock):
    arts = ttrain.train_all_persons(lock, _float64(PipelineConfig()), save=False, device=CPU)
    crops = teval._load_crops(os.path.join(lock, "ann")) + teval._load_crops(
        os.path.join(lock, "bob"))
    ids = [0] * 9 + [1] * 7
    arts.pop("bob")
    models_t = {n: tef.from_artifact(a, torch.float64, CPU) for n, a in arts.items()}
    models_j = {n: jef.from_artifact(a, np.float64) for n, a in arts.items()}
    data = {"all": (crops, ids), "bob": (crops[9:], [1] * 7)}
    got = teval.cross_lighting_eval(models_t, data, threshold=0.5)
    want = jeval.cross_lighting_eval(models_j, data, threshold=0.5)
    assert got.keys() == want.keys()
    for m in got:
        for d in got[m]:
            w = want[m][d]
            assert {k: v for k, v in got[m][d].items() if k != "mean_confidence"} == {
                k: v for k, v in w.items() if k != "mean_confidence"}
            assert abs(got[m][d]["mean_confidence"] - w["mean_confidence"]) <= CONF_ATOL
    assert got["multi_person"]["all"]["top1_accuracy"] == 1.0  # gallery self-match
    one = teval.evaluate_model(models_t["multi_person"], crops[:3], [0, 0, 0], threshold=1.1)
    assert one["reject_rate"] == 1.0


def test_holdout_eval_matches_jax(lock):
    got = teval.holdout_eval(lock, holdout_every=3, n_components=6, device=CPU)
    want = jeval.holdout_eval(lock, holdout_every=3, n_components=6)
    got.pop("eval_wall_s"), want.pop("eval_wall_s")
    assert abs(got.pop("mean_confidence") - want.pop("mean_confidence")) <= CONF_ATOL
    assert got == want
    assert got["n_train"] == 10 and got["persons"] == 2


class _FakeCapture:
    """``cv2.VideoCapture`` of a camera that gives ``n`` frames."""

    def __init__(self, index, n=5):
        self.frames = [np.full((48, 64, 3), 10 * i, np.uint8) for i in range(n)]
        self.set_calls = []

    def isOpened(self):
        return True

    def set(self, prop, value):
        self.set_calls.append((prop, value))
        return True

    def read(self):
        if not self.frames:
            return False, None
        return True, self.frames.pop(0)

    def release(self):
        pass


def test_record_camera_with_a_fake_capture(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    from face_detection_recognization_pca_tpu.io import video as jvideo

    real = cv2.VideoCapture
    monkeypatch.setattr(cv2, "VideoCapture", _FakeCapture)
    got = tvideo.record_camera(str(tmp_path / "t.mp4"), seconds=1.0, fps=4, size_wh=(64, 48))
    want = jvideo.record_camera(str(tmp_path / "j.mp4"), seconds=1.0, fps=4, size_wh=(64, 48))
    assert got == want == 4
    monkeypatch.setattr(cv2, "VideoCapture", real)
    reader = tvideo.VideoReader(str(tmp_path / "t.mp4"))
    assert (reader.meta.width, reader.meta.height, reader.meta.frame_count) == (64, 48, 4)
    reader.close()

    class Closed(_FakeCapture):
        def isOpened(self):
            return False

    monkeypatch.setattr(cv2, "VideoCapture", Closed)
    with pytest.raises(IOError, match="cannot open camera"):
        tvideo.record_camera(str(tmp_path / "x.mp4"))


def test_prefetching_feed_keeps_the_order():
    class Reader:
        def batches(self, batch, gray=False):
            for i in range(7):
                yield np.full((batch, 2, 2), i), batch - (i == 6)

    items = list(tvideo.PrefetchingFeed(Reader(), 3, gray=False, depth=2))
    assert [int(b[0][0, 0, 0]) for b in items] == list(range(7))
    assert [n for _, n in items] == [3] * 6 + [2]


def test_prefetching_feed_reads_a_video(tmp_path):
    pytest.importorskip("cv2")
    path = str(tmp_path / "clip.mp4")
    try:
        decoded = write_video(path, video_frames()[:5])
    except IOError as err:
        pytest.skip(f"OpenCV cannot write a video here: {err}")
    reader = tvideo.VideoReader(path)
    items = list(tvideo.PrefetchingFeed(reader, 2, gray=False))
    reader.close()
    assert [n for _, n in items] == [2, 2, 1]
    np.testing.assert_array_equal(np.concatenate([b[:n] for b, n in items]), decoded)


def test_stage_timer():
    """The tracer that took ``StageTimer``'s place: per-name counts in its
    summary while on, nothing while off."""
    profiling.reset()
    profiling.enable(True)
    try:
        for name in ("a", "a", "b"):
            with profiling.span(name):
                pass
    finally:
        profiling.enable(False)
    with profiling.span("a"):
        pass
    totals = profiling.snapshot()["totals"]
    assert totals["a"][0] == 2 and totals["b"][0] == 1
    assert "a: 2 spans" in profiling.summary() and "b: 1 spans" in profiling.summary()
    profiling.reset()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(None):
        pass
    assert not os.listdir(tmp_path)
    with device_trace(str(tmp_path / "trace")):
        torch.ones(8).cumsum(0)
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    assert trace["traceEvents"]
