"""Port parity for the host modules: model pickles cross between the two
packages in both directions, an artifact carried into the port recognizes
as the JAX package does, and the config and detection JSONs are the same
text."""

import dataclasses
import json
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu import config as jconfig
from face_detection_recognization_pca_tpu.io import artifacts as jart
from face_detection_recognization_pca_tpu.io import detection_json as jdet
from face_detection_recognization_pca_tpu.io import sklearn_shim as jshim
from face_detection_recognization_pca_tpu.models import eigenfaces as jef
from face_detection_recognization_pca_tpu.utils import logging as jlog
from face_detection_recognization_pca_tpu_torch import config as tconfig
from face_detection_recognization_pca_tpu_torch.io import artifacts as tart
from face_detection_recognization_pca_tpu_torch.io import detection_json as tdet
from face_detection_recognization_pca_tpu_torch.io import sklearn_shim as tshim
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as tef
from face_detection_recognization_pca_tpu_torch.utils import logging as tlog

torch.set_num_threads(1)

CPU = torch.device("cpu")
ARRAYS = ("components", "mean_face", "features", "labels", "scaler_mean", "scaler_scale",
          "projection_mean", "eigenvalues", "explained_variance_ratio")
SCALARS = ("person_id_map", "face_shape", "n_components", "schema", "person_name", "version",
           "training_date", "face_info", "training_filenames")


def _artifact(module, schema, dtype=np.float64, seed=0):
    """An artifact of ``module`` (either package's ``io.artifacts``) from
    seeded numpy arrays: 12 faces of 8 x 8, k = 5."""
    rng = np.random.default_rng(seed)
    n, d, k = 12, 64, 5
    comps = np.linalg.qr(rng.normal(size=(d, k)))[0].T.astype(dtype)
    images = rng.uniform(0, 255, (n, d)).astype(dtype)
    mean = images.mean(0)
    common = dict(
        components=comps, mean_face=mean, face_shape=(8, 8), n_components=k,
        eigenvalues=np.sort(rng.uniform(1, 9, k))[::-1].astype(dtype),
        training_date="2024-01-02T03:04:05",
    )
    if schema == "v1":
        return module.EigenfacesArtifact(
            **common, features=(images - mean) @ comps.T, labels=np.zeros(n, np.int64),
            person_id_map={"ann": 0}, schema="v1", projection_mean=mean, person_name="ann",
            version="v1-test", training_filenames=[f"face_{i}.jpg" for i in range(n)],
        )
    scale = images.std(0) + 1.0
    scaled = (images - mean) / scale
    return module.EigenfacesArtifact(
        **common, features=(scaled - scaled.mean(0)) @ comps.T,
        labels=(np.arange(n) % 3).astype(np.int64), person_id_map={"ann": 0, "bo": 1, "cy": 2},
        schema="v2", scaler_mean=mean, scaler_scale=scale, projection_mean=scaled.mean(0),
        explained_variance_ratio=np.linspace(0.4, 0.05, k).astype(dtype),
        face_info=[{"path": f"p{i}.jpg", "person": i % 3} for i in range(n)],
    )


def _assert_same_artifact(a, b, schema):
    for name in ARRAYS:
        va, vb = getattr(a, name), getattr(b, name)
        if va is None or vb is None:
            assert va is None and vb is None, name
        else:
            assert np.asarray(va).dtype == np.asarray(vb).dtype, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
    for name in SCALARS:
        assert getattr(a, name) == getattr(b, name), name
    assert a.schema == schema and a.names_by_id == b.names_by_id


def _lost_on_disk(art, schema):
    """What the file formats do not hold, cleared, so that a loaded
    artifact can be compared with the one that was saved."""
    if schema == "v1":
        return dataclasses.replace(art, explained_variance_ratio=None)
    return dataclasses.replace(art, person_name=None, version=None, training_filenames=None)


@pytest.fixture(params=["sklearn", "shims"])
def estimators(request, monkeypatch):
    """Write v2 pickles with real sklearn estimators (skipped where sklearn
    is absent) or, with sklearn's import blocked, with the writer's shims."""
    if request.param == "sklearn":
        pytest.importorskip("sklearn.decomposition")
    else:
        monkeypatch.setitem(sys.modules, "sklearn.decomposition", None)
    return request.param


@pytest.mark.parametrize("schema", ["v1", "v2"])
@pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("jax", "torch"),
                                           ("torch", "jax")])
def test_model_pickles_cross_between_the_packages(tmp_path, estimators, schema, writer, reader):
    modules = {"torch": tart, "jax": jart}
    art = _artifact(modules[writer], schema)
    path = str(tmp_path / "face_model.pkl")
    getattr(modules[writer], f"save_model_{schema}")(art, path)
    loaded = modules[reader].load_model(path)
    assert type(loaded) is modules[reader].EigenfacesArtifact
    _assert_same_artifact(loaded, _lost_on_disk(art, schema), schema)
    if schema == "v2":
        # The class paths inside the file are the hazard: sklearn's own, or
        # the writer's shims'.  The port maps all of them onto its shims by
        # name; the JAX package maps sklearn's and imports the port's.
        with open(path, "rb") as f:
            data = f.read()
        named = {"sklearn": b"sklearn.decomposition._pca",
                 "shims": {"torch": tshim, "jax": jshim}[writer].__name__.encode()}[estimators]
        assert named in data
        raw = modules[reader]._shim_loads(data)
        if reader == "torch":
            assert type(raw["pca"]) is tshim.PCAShim
            assert type(raw["scaler"]) is tshim.StandardScalerShim
        else:
            assert type(raw["pca"]) in (tshim.PCAShim, jshim.PCAShim)
        x = np.random.default_rng(3).uniform(0, 255, (2, 64))
        want = (((x - art.scaler_mean) / art.scaler_scale) - art.projection_mean) \
            @ art.components.T
        np.testing.assert_allclose(raw["pca"].transform(raw["scaler"].transform(x)), want,
                                   rtol=1e-12)


def test_loader_refuses_what_it_does_not_know(tmp_path):
    """Other sklearn classes are refused, as the JAX package refuses them."""
    path = str(tmp_path / "m.pkl")
    blob = b"csklearn.cluster._kmeans\nKMeans\n."  # a protocol-0 pickle of that class
    for module in (tart, jart):
        with pytest.raises(pickle.UnpicklingError, match="unsupported sklearn class"):
            module._shim_loads(blob)
    with pytest.raises(ValueError, match="unrecognized model pickle"):
        bad = tmp_path / "bad.pkl"
        bad.write_bytes(pickle.dumps([1, 2]))
        tart.load_model(str(bad))
    with pytest.raises(ValueError, match="requires scaler"):
        tart.save_model_v2(_artifact(tart, "v1"), path)


@pytest.mark.parametrize("schema", ["v1", "v2"])
def test_model_info_json_equals_jax(tmp_path, schema):
    a, b = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tart.write_model_info_json(_artifact(tart, schema), a)
    jart.write_model_info_json(_artifact(jart, schema), b)
    assert open(a).read() == open(b).read()
    assert json.load(open(a))["n_faces"] == 12


@pytest.mark.parametrize("schema", ["v1", "v2"])
@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5), (np.float64, 1e-12)])
def test_from_artifact_recognizes_as_jax(tmp_path, schema, dtype, atol):
    """The carry-over of weights: a file saved by the JAX package, loaded
    by each package's own loader, recognizes the same crops the same."""
    rng = np.random.default_rng(5)
    n, side, k = 18, 16, 7
    images = rng.uniform(0, 255, (n, side * side)).astype(np.float64)
    labels = jnp.asarray(np.arange(n, dtype=np.int32) % 5)
    if schema == "v1":
        jmodel, aux = jef.train_v1(jnp.asarray(images), n_components=k)
    else:
        jmodel, aux = jef.train_v2(jnp.asarray(images), labels, n_components=k,
                                   face_shape=(side, side))
    path = str(tmp_path / "face_model.pkl")
    getattr(jart, f"save_model_{schema}")(jef.to_artifact(jmodel, aux, person_name="ann"), path)
    jmodel = jef.from_artifact(jart.load_model(path), dtype=dtype)
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    tmodel = tef.from_artifact(tart.load_model(path), tdtype, CPU)
    assert tmodel.schema == schema and tmodel.face_shape == (side, side)
    assert tmodel.components.dtype == tdtype and tmodel.labels.dtype == torch.int32
    assert (tmodel.scaler_mean is None) == (schema == "v1")

    crops = np.concatenate([
        images[:6].reshape(6, side, side) + rng.normal(0, 2, (6, side, side)),
        rng.uniform(0, 255, (6, side, side)),
    ]).astype(dtype)
    ids_j, conf_j = jef.recognize(jmodel, jnp.asarray(crops), threshold=0.9)
    ids_t, conf_t = tef.recognize(tmodel, torch.from_numpy(crops), threshold=0.9)
    assert conf_t.dtype == tdtype
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j), rtol=0, atol=atol)
    assert (ids_t[:6] >= 0).all() and (ids_t[6:] == -1).all()

    # And back: the port's to_artifact gives the arrays it was given.
    back = tef.to_artifact(tmodel, {"eigenvalues": torch.arange(k)}, person_name="ann")
    np.testing.assert_array_equal(back.components, tmodel.components.numpy())
    np.testing.assert_array_equal(back.features, tmodel.gallery.numpy())
    np.testing.assert_array_equal(back.eigenvalues, np.arange(k))
    assert back.person_name == "ann" and back.n_components == k and back.schema == schema


def test_pipeline_config_json_equals_jax():
    tcfg, jcfg = tconfig.PipelineConfig(), jconfig.PipelineConfig()
    assert tcfg.to_json() == jcfg.to_json()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    text = json.dumps({
        "detect": {"template_scales": [0.5, 1.0], "min_size": [24, 24], "max_detections": 4},
        "train": {"n_components": 20, "method": "snapshot"},
        "recognize": {"cosine_threshold": 0.55},
        "video": {"batch_frames": 16, "live_size": [320, 240]},
        "paths": {"lock_dir": "elsewhere/lock"},
        "parallel": {"data_parallel": 4, "model_parallel": 2},
    })
    tcfg, jcfg = tconfig.PipelineConfig.from_json(text), jconfig.PipelineConfig.from_json(text)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.to_json() == jcfg.to_json()
    assert tcfg.detect.template_scales == (0.5, 1.0) and tcfg.paths.lock_dir == "elsewhere/lock"
    assert tconfig.PipelineConfig.from_json(tcfg.to_json()) == tcfg
    for bad in ('{"faces_root": "x"}', '{"paths": {"lock": "x"}}'):
        with pytest.raises(ValueError, match="unknown config key"):
            tconfig.PipelineConfig.from_json(bad)
        with pytest.raises(ValueError, match="unknown config key"):
            jconfig.PipelineConfig.from_json(bad)


def _detection_file(module):
    faces = [
        module.DetectionRecord(
            face_id=i, frame_number=3 * i, timestamp=3 * i / 25.0, x=10 + i, y=20 + 2 * i,
            width=64, height=64, center_x=42 + i, center_y=52 + 2 * i, area=4096,
            image_path=f"faces/ann/face_{i}_frame_{3 * i}.jpg",
            image_filename=f"face_{i}_frame_{3 * i}.jpg")
        for i in range(4)
    ]
    return module.DetectionFile("vidéo.mp4", 100, 25.0, 4, "2024-01-02T03:04:05", faces)


def test_detection_json_equals_jax(tmp_path):
    a, b = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tdet.write_detection_json(_detection_file(tdet), a)
    jdet.write_detection_json(_detection_file(jdet), b)
    assert open(a, "rb").read() == open(b, "rb").read()
    # Each package reads the other's file.
    got, ref = tdet.read_detection_json(b), jdet.read_detection_json(a)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(got) == dataclasses.asdict(_detection_file(tdet))
    # Defaults for a sparse record, and the guided scanner's priors.
    sparse = tmp_path / "s.json"
    sparse.write_text(json.dumps({"faces": [{"x": 4, "y": 6, "width": 10, "height": 20}]}))
    got, ref = tdet.read_detection_json(str(sparse)), jdet.read_detection_json(str(sparse))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.faces[0].center_x == 9 and got.faces[0].area == 200 and got.fps == 30.0
    near_t = tdet.reference_positions(_detection_file(tdet), 5, tolerance=4)
    near_j = jdet.reference_positions(_detection_file(jdet), 5, tolerance=4)
    assert [r.frame_number for r in near_t] == [r.frame_number for r in near_j] == [6, 3, 9]


def test_generate_detection_json_equals_jax(tmp_path):
    person = tmp_path / "ann"
    person.mkdir()
    for name in ("face_0_frame_12.jpg", "ann_face_7.png", "plain.jpg", "eigenface_1.jpg",
                 "mean_face.jpg", "notes.txt"):
        (person / name).write_bytes(b"")
    size = lambda path: (48, 40)  # noqa: E731
    got = tdet.generate_detection_json(str(person), fps=25.0, image_size_fn=size,
                                       output_path=str(tmp_path / "t.json"))
    ref = jdet.generate_detection_json(str(person), fps=25.0, image_size_fn=size)
    got_d, ref_d = dataclasses.asdict(got), dataclasses.asdict(ref)
    assert got_d.pop("processing_date") and ref_d.pop("processing_date")
    assert got_d == ref_d
    assert [f.frame_number for f in got.faces] == [7, 12, 2] and got.total_frames == 13
    assert dataclasses.asdict(jdet.read_detection_json(str(tmp_path / "t.json")))["faces"] \
        == got_d["faces"]


def test_counters_summary_equals_jax():
    assert tlog.get_logger("fdrp.test").name == "fdrp.test"
    tc, jc = tlog.Counters(), jlog.Counters()
    for c in (tc, jc):
        c.inc("frames", 10)
        c.inc("frames_with_detection", 8)
        c.inc("frames_recognized", 6)
    assert tc.recognition_summary() == jc.recognition_summary()
    assert tc.as_dict() == jc.as_dict() and tc.get("frames") == 10
    assert tlog.Counters().recognition_summary().endswith("Recognition rate: 0.0%")
