"""The plain reference agrees with the port at a tiny size: the Haar
boxes exactly, the tracker's places and scores and the eigenfaces' cosines
to float32's rounding; its OpenCV parts agree with OpenCV where it is
installed."""

import numpy as np
import pytest
import torch

from benchmark import generators
from benchmark.reference import eigenfaces, haar
from benchmark.reference.numerics import Arith, tf32_round
from conftest import ROOT

CASCADE = str(ROOT / "benchmark" / "reference" / "haarcascade_frontalface_default.xml")


def test_the_reference_cascade_boxes_what_the_port_boxes():
    from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector, load_cascade

    frames = generators.haar_scenes(generators.rng_for(5), 4, (180, 240), [1, 2, 3, 4],
                                            1, (40, 90), (110, 25))
    gray = haar.gray_u8(frames)
    want = HaarDetector(cascade=load_cascade(CASCADE), device="cpu").detect_multi_scale_batch(gray)
    got = haar.detect(torch.from_numpy(gray), haar.load(CASCADE), Arith())
    assert [sorted(g) for g in got] == [sorted(map(tuple, w)) for w in want]
    assert all(len(g) == 1 for g in got)


def test_group_rectangles_as_the_port_groups_them():
    from face_detection_recognization_pca_tpu_torch.detect.haar import _group_rectangles_py

    rng = np.random.default_rng(3)
    rects = [tuple(int(v) for v in r) for r in
             np.concatenate([rng.integers(40, 44, (12, 2)), rng.integers(100, 104, (7, 2)),
                             rng.integers(0, 200, (9, 2))]).tolist()]
    rects = [(x, y, 30 + (x % 3), 30 + (x % 3)) for x, y in rects]
    assert sorted(haar.group_rectangles(rects, 5)) == sorted(_group_rectangles_py(rects, 5))


def test_the_reference_tracker_agrees_with_the_recognizer():
    from face_detection_recognization_pca_tpu_torch.models.eigenfaces import train_v1
    from face_detection_recognization_pca_tpu_torch.parallel.multistream import MultiStreamRecognizer
    from benchmark.reference import tracker

    rng = generators.rng_for(9)
    face = generators.planted_face(rng, 32)
    gallery = generators.mode_gallery(rng, face, 40, 4, 20.0, 1.0)
    template = gallery[0].reshape(32, 32).copy()
    plants = generators.back_and_forth(rng, 3, 2, (3, 6), (64, 64), (100, 160))
    frames = generators.noise_frames((6, 200, 256), 9, torch.device("cpu"), 110.0, 25.0)
    generators.plant_noisy(frames, template, plants, 110.0, 25.0, 8.0)
    frames = frames.view(2, 3, 200, 256)
    model, _ = train_v1(torch.from_numpy(gallery), n_components=12)
    msr = MultiStreamRecognizer(model, template, window=64)
    origin0 = np.stack([plants[0, :, 0] - 16, plants[0, :, 1] - 16], 1)
    ref = tracker.track(frames, template, origin0, eigenfaces.snapshot_pca(
        torch.from_numpy(gallery), 12, Arith()), 64, Arith())
    state = msr.init_state(3, (200, 256), np.stack([plants[0, :, 1], plants[0, :, 0],
                                                    np.zeros(3), np.zeros(3)], 1).astype(int))
    for step in range(3):
        out, state = msr.process_batch(frames[step % 2], state)
        best = ref["best"][step]
        assert np.array_equal(out["x"].numpy(), ref["origin"][step][:, 1] + best % 33)
        assert np.array_equal(out["y"].numpy(), ref["origin"][step][:, 0] + best // 33)
        tm = ref["scores"][step][np.arange(3), best]
        assert np.abs(out["template_confidence"].numpy() - tm).max() < 1e-5
        rows = ref["cos"][step].argmax(axis=1)
        assert np.array_equal(out["gallery_row"].numpy(), rows)
        assert np.abs(out["confidence"].numpy() - ref["cos"][step].max(axis=1)).max() < 1e-5


def test_the_reference_eigenfaces_agree_with_the_port():
    from face_detection_recognization_pca_tpu_torch.models.eigenfaces import recognize, train_v2

    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.normal(100, 20, (30, 64)))
    model, _ = train_v2(images, torch.arange(30, dtype=torch.int32), n_components=10,
                        face_shape=(8, 8))
    ref = eigenfaces.scaled_pca(images, 10, Arith())
    probes = torch.from_numpy(rng.normal(100, 20, (5, 8, 8)))
    ids, conf = recognize(model, probes, threshold=-2.0)
    cos = eigenfaces.cosines(ref, eigenfaces.resize(probes, (8, 8), Arith()).reshape(5, -1), Arith())
    assert np.array_equal(ids.numpy(), cos.argmax(dim=1).numpy())
    assert np.allclose(conf.numpy(), cos.max(dim=1).values.numpy(), atol=1e-9)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -(1.0 + 2 ** -10)], dtype=torch.float32)
    assert tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10)]


def test_gray_and_resize_as_opencv_gives_them():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    assert np.array_equal(haar.gray_u8(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
    img = rng.normal(100, 30, (37, 53)).astype(np.float32)
    for size in ((20, 30), (64, 64), (50, 80)):
        want = cv2.resize(img, (size[1], size[0]), interpolation=cv2.INTER_LINEAR)
        got = eigenfaces.resize(torch.from_numpy(img), size, Arith()).numpy()
        assert np.abs(got - want).max() < 1e-3
