"""Port parity for the enhanced ensemble (``models/enhanced.py``) and its
scan (``scan_app.scan_enhanced_video``) against the JAX package under the
suite's x64: branch features, training (scalers, components after sign
alignment, galleries), recognition, both pickle layouts crossing between
the packages, the profile cascade, and the scan of one mp4.

The JAX scan gets the port's detections through
``haar_scenes.ReplayDetector`` (frontal and profile cascades): a JAX
``HaarDetector`` call compiles for minutes per frame size on the CPU."""

import os
import pickle

import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.detect import haar as jhaar
from face_detection_recognization_pca_tpu.models import enhanced as jenh
from face_detection_recognization_pca_tpu_torch import bench
from face_detection_recognization_pca_tpu_torch.detect import haar as thaar
from face_detection_recognization_pca_tpu_torch.device import exact_float32
from face_detection_recognization_pca_tpu_torch.models import enhanced as tenh
from face_detection_recognization_pca_tpu_torch.ops.resize import resize_bilinear
from haar_scenes import ReplayDetector, numpy_cascade_accepts, video_frames, write_video

torch.set_num_threads(1)

CPU = torch.device("cpu")
REL = 1e-6  # training arrays: of each array's largest magnitude
CONF_ATOL = 1e-6  # recognition confidences (float64 branch arithmetic)


def _crops(n=8, seed=5):
    """``n`` uint8 gray crops of two persons' ``bench.haar_face`` at two
    sizes (90 and 120 px squares), with N(0, 3) noise."""
    rng = np.random.default_rng(seed)
    out, labels = [], []
    for i in range(n):
        side = 90 if i % 2 else 120
        patch = bench.haar_face(side, 1 + (i // 2) % 2)
        m = (patch.shape[0] - side) // 2
        face = patch[m:m + side, m:m + side].astype(np.float64)
        out.append(np.clip(np.rint(face + rng.normal(0, 3, face.shape)), 0, 255).astype(np.uint8))
        labels.append((i // 2) % 2)
    return out, labels


PERSONS = {"ann": 0, "bob": 1}


@pytest.fixture(scope="module")
def trained():
    """(crops, labels, port model, JAX model), both trained with
    augmentation on the same crops."""
    crops, labels = _crops()
    got = tenh.train_enhanced(crops, labels, PERSONS, device=CPU)
    ref = jenh.train_enhanced(crops, labels, PERSONS)
    return crops, labels, got, ref


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("profile", [False, True])
def test_branch_features_match_jax(profile):
    crops, _ = _crops(3)
    for crop in crops + [crops[0][:, :77]]:
        got = tenh.extract_branch_features(crop, profile, device=CPU)
        want = jenh.extract_branch_features(crop, profile)
        assert list(got) == list(want) == list(tenh.BRANCHES)
        for b in ("scale_48", "scale_64", "scale_80", "lbp"):
            np.testing.assert_array_equal(got[b].numpy(), want[b])
        np.testing.assert_allclose(got["hog"].numpy(), want["hog"], rtol=0, atol=1e-6)
    batch = tenh.extract_branch_features_batch(torch.from_numpy(np.stack(crops[::2])), profile)
    for i, crop in enumerate(crops[::2]):
        single = tenh.extract_branch_features(crop, profile, device=CPU)
        assert all(torch.equal(batch[b][i], single[b]) for b in tenh.BRANCHES)


def test_train_enhanced_matches_jax(trained):
    crops, labels, got, ref = trained
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert len(got.labels) == 7 * len(crops)
    assert got.person_id_map == ref.person_id_map and got.n_components == ref.n_components
    for b in tenh.BRANCHES:
        g, r = got.branches[b], ref.branches[b]
        _close(g.scaler.mean, r.scaler.mean)
        _close(g.scaler.scale, r.scaler.scale)
        np.testing.assert_allclose(g.projection_mean.numpy(), r.projection_mean, atol=1e-9)
        comps = g.components.numpy()
        sign = np.sign(np.sum(comps * r.components, axis=1))
        assert np.all(sign != 0)
        _close(comps * sign[:, None], r.components)
        _close(g.gallery.numpy() * sign[None, :], r.gallery)


def test_train_without_augmentation_and_with_profiles(trained):
    crops, labels, _, _ = trained
    flags = [i % 3 == 0 for i in range(len(crops))]
    got = tenh.train_enhanced(crops, labels, PERSONS, augment=False, profile_flags=flags,
                              device=CPU)
    ref = jenh.train_enhanced(crops, labels, PERSONS, augment=False, profile_flags=flags)
    np.testing.assert_array_equal(got.labels, ref.labels)
    for b in tenh.BRANCHES:
        g, r = got.branches[b], ref.branches[b]
        _close(g.scaler.mean, r.scaler.mean)
        sign = np.sign(np.sum(g.components.numpy() * r.components, axis=1))
        _close(g.gallery.numpy() * sign[None, :], r.gallery)


@pytest.mark.parametrize("profile", [False, True])
def test_recognize_matches_jax(trained, profile):
    crops, _, got, ref = trained
    rng = np.random.default_rng(11)
    probes = crops[:3] + [bench.haar_face(100, 2)[12:112, 12:112],
                          rng.integers(0, 256, (70, 90), dtype=np.uint8)]
    outs = tenh.recognize_enhanced_batch(got, probes, [profile] * len(probes))
    for probe, (pid, name, conf) in zip(probes, outs):
        want = jenh.recognize_enhanced(ref, probe, profile)
        assert (pid, name) == want[:2]
        assert abs(conf - want[2]) <= CONF_ATOL
        # One crop alone: float64 products of another shape, so the last bits.
        single = tenh.recognize_enhanced(got, probe, profile)
        assert single[:2] == (pid, name) and abs(single[2] - conf) <= 1e-12


def _arrays(model):
    out = {"labels": np.asarray(model.labels)}
    for b, br in model.branches.items():
        for key, value in (("mean", br.scaler.mean), ("scale", br.scaler.scale),
                           ("components", br.components), ("pm", br.projection_mean),
                           ("gallery", br.gallery)):
            out[f"{b}/{key}"] = np.asarray(value.cpu() if isinstance(value, torch.Tensor) else value)
    return out


def test_pickles_cross_between_the_packages(trained, tmp_path):
    _, _, got, ref = trained
    tenh.save_enhanced(got, str(tmp_path / "t.pkl"))
    jenh.save_enhanced(ref, str(tmp_path / "j.pkl"))
    for path, model in (("t.pkl", got), ("j.pkl", ref)):
        a = tenh.load_enhanced(str(tmp_path / path), device=CPU)
        b = jenh.load_enhanced(str(tmp_path / path))
        want = _arrays(model)
        for arrays in (_arrays(a), _arrays(b)):
            assert arrays.keys() == want.keys()
            for key in want:
                np.testing.assert_array_equal(arrays[key], want[key])
        assert a.person_id_map == b.person_id_map == model.person_id_map
        assert a.augmentation_factor == b.augmentation_factor == 6
    raw = pickle.load(open(tmp_path / "t.pkl", "rb"))
    assert raw["model_type"] == "enhanced" and set(raw["trained_models"]) == set(tenh.BRANCHES)
    assert raw["pca_models"]["hog"] is raw["trained_models"]["hog"]["pca"]


def test_plain_array_pickle_layout_loads_in_both(trained, tmp_path):
    _, _, got, _ = trained
    data = {
        "model_type": "enhanced",
        "face_labels": got.labels,
        "person_id_map": dict(PERSONS),
        "trained_models": {
            b: {"scaler_mean": br.scaler.mean.numpy(), "scaler_scale": br.scaler.scale.numpy(),
                "components": br.components.numpy(), "projection_mean": br.projection_mean.numpy(),
                "gallery": br.gallery.numpy()}
            for b, br in got.branches.items()
        },
    }
    path = str(tmp_path / "plain.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    want = _arrays(got)
    for model in (tenh.load_enhanced(path, device=CPU), jenh.load_enhanced(path)):
        arrays = _arrays(model)
        for key in want:
            np.testing.assert_array_equal(arrays[key], want[key])
        assert model.n_components == 100
    with open(path, "wb") as f:
        pickle.dump({"model_type": "v2"}, f)
    with pytest.raises(ValueError, match="not an enhanced"):
        tenh.load_enhanced(path, device=CPU)


def test_profile_cascade_is_package_data_equal_in_both_packages():
    path = tenh.PROFILE_CASCADE
    assert os.path.getsize(path) == 828514
    got, want = thaar.load_cascade(path), jhaar.load_cascade(path)
    assert got.window_size == want.window_size == (20, 20)
    assert (got.n_stages, got.n_stumps) == (26, 2609)
    for field in ("stage_thresholds", "stage_offsets", "stump_feature", "stump_threshold",
                  "leaf0", "leaf1", "rects", "corner_matrix"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_profile_detector_accepts_what_the_numpy_cascade_accepts():
    """On the level of one frame that accepts most windows, the profile
    detector's accepted windows equal the float64 numpy cascade's."""
    det = tenh.profile_detector(CPU)
    gray = video_frames()[2, :, :, 0]
    handle = det.detect_device(gray[None])
    rows = handle["rows"].numpy()
    level = int(np.bincount(rows[:, 1]).argmax())
    _, sh, sw, step = handle["levels"][level]
    with exact_float32():
        scaled = resize_bilinear(torch.from_numpy(gray).to(torch.float32), (sw, sh)).numpy()
    got = {(int(x), int(y)) for _, lv, y, x in rows if lv == level}
    assert got and got == numpy_cascade_accepts(scaled, det.cascade, step)


def test_face_angle_raises_without_its_cascade(monkeypatch, tmp_path):
    monkeypatch.setattr(tenh, "PROFILE_CASCADE", str(tmp_path / "missing.xml"))
    monkeypatch.setattr(tenh, "_profile_detectors", {})
    with pytest.raises(FileNotFoundError, match="profile cascade"):
        tenh.detect_face_angle(np.zeros((40, 40), np.uint8), CPU)


def test_scan_enhanced_video_matches_jax(trained, tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    _, _, got, _ = trained
    path = str(tmp_path / "clip.mp4")
    try:
        write_video(path, video_frames())
    except IOError as err:
        pytest.skip(f"OpenCV cannot write a video here: {err}")
    lock = tmp_path / "lock"
    os.makedirs(lock / "ann")
    tenh.save_enhanced(got, str(lock / "ann" / "enhanced_model.pkl"))
    frontal = thaar.HaarDetector(device=CPU)
    monkeypatch.setattr(jhaar, "HaarDetector", lambda *a, **k: ReplayDetector(frontal))
    monkeypatch.setattr(jenh, "_profile_detector", ReplayDetector(tenh.profile_detector(CPU)))
    from face_detection_recognization_pca_tpu.pipeline import scan_app as jscan
    from face_detection_recognization_pca_tpu_torch.pipeline import scan_app as tscan

    want = jscan.scan_enhanced_video(path, "ann", str(lock))
    records = tscan.scan_enhanced_video(path, "ann", str(lock), str(tmp_path / "out.mp4"),
                                        device=CPU)
    assert len(records) == len(want) >= 5
    for r, w in zip(records, want):
        conf, wconf = r.pop("confidence"), w.pop("confidence")
        assert r == w
        assert abs(conf - wconf) <= CONF_ATOL
    assert os.path.exists(tmp_path / "out.mp4")
    assert {r["angle"] for r in records} <= {"frontal", "left_profile", "right_profile"}
