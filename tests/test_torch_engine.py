"""Port parity: ``recognize/engine.py`` and ``recognize/fusion.py`` against
the JAX package, on three models of different k and gallery size built
from the same numpy artifacts."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.io import artifacts as jart
from face_detection_recognization_pca_tpu.recognize import engine as jengine
from face_detection_recognization_pca_tpu.recognize import fusion as jfusion
from face_detection_recognization_pca_tpu_torch.io import artifacts as tart
from face_detection_recognization_pca_tpu_torch.recognize import engine as tengine
from face_detection_recognization_pca_tpu_torch.recognize import fusion as tfusion

torch.set_num_threads(1)

CPU = torch.device("cpu")
FACE = (10, 12)  # (h, w)
# Cosines <= 1 from float32 products summed in other orders.
CONF_ATOL = 1e-5
STACK_FIELDS = ("components", "projection_mean", "scaler_mean", "scaler_scale", "gallery",
                "gallery_mask", "labels")


def _artifact_fields(seed, k, n, scaled, id_map):
    """One person's model as plain numpy fields: orthonormal components,
    a gallery that projects ``n`` training faces, labels cycling through
    the ids of ``id_map``."""
    rng = np.random.default_rng(seed)
    d = FACE[0] * FACE[1]
    train = rng.normal(120, 35, (n, d)).astype(np.float32)
    comps = np.linalg.qr(rng.normal(size=(d, k)))[0].T.astype(np.float32)
    smean = sscale = None
    x = train
    if scaled:
        smean, sscale = train.mean(0), train.std(0) + 0.5
        x = (train - smean) / sscale
    pmean = x.mean(0).astype(np.float32)
    ids = sorted(id_map.values()) or [0]
    fields = dict(
        components=comps, mean_face=train.mean(0), features=((x - pmean) @ comps.T),
        labels=np.array([ids[i % len(ids)] for i in range(n)], np.int64),
        person_id_map=id_map, face_shape=FACE, n_components=k, schema="v2" if scaled else "v1",
        scaler_mean=smean, scaler_scale=sscale, projection_mean=pmean if scaled else None,
    )
    return fields, train


@pytest.fixture(scope="module")
def models():
    """(name, fields, training faces) of three persons: k = 5, 9 and 7,
    galleries of 14, 6 and 10 rows, two scaled and one centre-only; the
    last has no id map, so its rows resolve to the model's own name."""
    specs = [("ann", 1, 5, 14, True, {"ann": 0, "ann_glasses": 3}),
             ("bob", 2, 9, 6, False, {"bob": 0}),
             ("cy", 3, 7, 10, True, {})]
    return [(name, *_artifact_fields(seed, k, n, scaled, id_map))
            for name, seed, k, n, scaled, id_map in specs]


def _stacks(models):
    jstack = jengine.ModelStack.build(
        [(name, jart.EigenfacesArtifact(**fields)) for name, fields, _ in models])
    tstack = tengine.ModelStack.build(
        [(name, tart.EigenfacesArtifact(**fields)) for name, fields, _ in models], device=CPU)
    return jstack, tstack


def test_model_stack_holds_the_jax_stacks_arrays(models):
    jstack, tstack = _stacks(models)
    for name in STACK_FIELDS:
        got, ref = getattr(tstack, name).numpy(), np.asarray(getattr(jstack, name))
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert tuple(tstack.components.shape) == (3, 9, 120)
    assert tuple(tstack.gallery.shape) == (3, 14, 9)
    assert tstack.gallery_mask.sum(dim=1).tolist() == [14, 6, 10]
    assert (tstack.scaler_scale[1] == 1).all() and (tstack.scaler_mean[1] == 0).all()
    assert tstack.model_names == jstack.model_names == ["ann", "bob", "cy"]
    assert tstack.names_by_id == jstack.names_by_id
    assert tstack.names_by_id[2] == {0: "cy"}
    assert tstack.face_shape == jstack.face_shape == FACE and tstack.device == CPU
    mixed = [(n, tart.EigenfacesArtifact(**{**f, "face_shape": (12, 10) if n == "bob" else FACE}))
             for n, f, _ in models]
    with pytest.raises(ValueError, match="mixed face shapes"):
        tengine.ModelStack.build(mixed, device=CPU)


def _crops(models):
    """Training faces of each model (score 1 in their own model), a
    blend that stays above the threshold, and noise that falls below."""
    rng = np.random.default_rng(9)
    h, w = FACE
    rows = [models[0][2][1], models[1][2][4], models[2][2][3], models[0][2][6],
            0.85 * models[1][2][0] + 0.15 * models[1][2][1],
            rng.uniform(0, 255, h * w), rng.uniform(0, 255, h * w), np.full(h * w, 97.0)]
    return np.stack(rows).reshape(-1, h, w).astype(np.float32)


@pytest.mark.parametrize("threshold", [None, 0.8, 0.999])
def test_recognize_batch_matches_jax(models, threshold):
    jstack, tstack = _stacks(models)
    crops = _crops(models)
    ref = jengine.MultiModelRecognizer(jstack).recognize_batch(crops, threshold)
    got = tengine.MultiModelRecognizer(tstack).recognize_batch(crops, threshold)
    assert len(got) == len(ref) == len(crops)
    for (pid, name, conf), (rpid, rname, rconf) in zip(got, ref):
        assert type(pid) is int and type(conf) is float
        assert (pid, name) == (rpid, rname)
        assert abs(conf - rconf) <= CONF_ATOL
    thr = 0.7 if threshold is None else threshold
    assert [g[:2] for g in got[:4]] == [(3, "ann_glasses"), (0, "bob"), (0, "cy"), (0, "ann")]
    assert all(g[2] > 0.9999 for g in got[:4])
    # Below the threshold: id -1, and the winning model's own name.
    below = [g for g in got if g[2] < thr]
    assert below and all(g[0] == -1 and g[1] in ("ann", "bob", "cy") for g in below)
    # A tensor batch, and one crop alone, give the same.
    again = tengine.MultiModelRecognizer(tstack).recognize_batch(torch.from_numpy(crops), threshold)
    assert again == got
    one = tengine.MultiModelRecognizer(tstack).recognize_one(crops[1], threshold)
    assert one[:2] == got[1][:2] and abs(one[2] - got[1][2]) <= CONF_ATOL


def test_recognize_batch_bgr_crops_match_jax(models):
    jstack, tstack = _stacks(models)
    rng = np.random.default_rng(10)
    crops = rng.integers(0, 256, (4, 23, 31, 3)).astype(np.uint8)  # resized to the face shape
    ref = jengine.MultiModelRecognizer(jstack).recognize_batch(crops)
    got = tengine.MultiModelRecognizer(tstack).recognize_batch(crops)
    for (pid, name, conf), (rpid, rname, rconf) in zip(got, ref):
        assert (pid, name) == (rpid, rname) and abs(conf - rconf) <= CONF_ATOL


def test_all_padding_gives_unknown(models):
    """With every gallery row masked out no score is finite: each crop is
    ``(-1, "unknown", 0.0)``, as in the JAX package."""
    jstack, tstack = _stacks(models)
    jstack = dataclasses.replace(jstack, gallery_mask=jnp.zeros_like(jstack.gallery_mask))
    tstack = dataclasses.replace(tstack, gallery_mask=torch.zeros_like(tstack.gallery_mask))
    crops = _crops(models)[:3]
    ref = jengine.MultiModelRecognizer(jstack).recognize_batch(crops)
    got = tengine.MultiModelRecognizer(tstack).recognize_batch(crops)
    assert got == ref == [(-1, "unknown", 0.0)] * 3
    # One model masked out alone never wins: its rows score -inf.
    jstack, tstack = _stacks(models)
    mask = tstack.gallery_mask.clone()
    mask[1] = False
    tstack = dataclasses.replace(tstack, gallery_mask=mask)
    jstack = dataclasses.replace(jstack, gallery_mask=jnp.asarray(mask.numpy()))
    crops = _crops(models)
    got = tengine.MultiModelRecognizer(tstack).recognize_batch(crops)
    ref = jengine.MultiModelRecognizer(jstack).recognize_batch(crops)
    assert [g[:2] for g in got] == [r[:2] for r in ref]
    assert all(g[1] != "bob" for g in got)


def test_score_all_models_matches_jax(models):
    jstack, tstack = _stacks(models)
    crops = _crops(models)
    args = ("components", "projection_mean", "scaler_mean", "scaler_scale", "gallery",
            "gallery_mask")
    best_r, row_r = jengine._score_all_models(
        jnp.asarray(crops), *(getattr(jstack, a) for a in args), FACE[1], FACE[0])
    best, row = tengine._score_all_models(
        torch.from_numpy(crops), *(getattr(tstack, a) for a in args), FACE[1], FACE[0])
    assert tuple(best.shape) == (3, len(crops))
    np.testing.assert_allclose(best.numpy(), np.asarray(best_r), atol=CONF_ATOL)
    np.testing.assert_array_equal(row.numpy()[:, :5], np.asarray(row_r)[:, :5])


def test_from_lock_dir_reads_what_the_jax_package_wrote(models, tmp_path):
    for name, fields, _ in (models[0], models[2]):  # the two v2 models
        (tmp_path / name).mkdir()
        jart.save_model_v2(jart.EigenfacesArtifact(**fields),
                           str(tmp_path / name / "face_model.pkl"))
    (tmp_path / "empty_dir").mkdir()
    jstack = jengine.ModelStack.from_lock_dir(str(tmp_path))
    tstack = tengine.ModelStack.from_lock_dir(str(tmp_path), device=CPU)
    assert tstack.model_names == jstack.model_names == ["ann", "cy"]
    for name in STACK_FIELDS:
        np.testing.assert_array_equal(getattr(tstack, name).numpy(),
                                      np.asarray(getattr(jstack, name)), err_msg=name)


@pytest.mark.parametrize(
    "args",
    [("ann", 0.9, "ann", 0.95), ("ann", 0.9, "bob", 0.95), ("ann", 0.9, "bob", 0.4),
     ("ann", 0.65, "ann", 0.95), ("ann", 0.9, "ann", 0.75), ("ann", 0.7, "bob", 0.8)],
)
def test_fusion_rules_match_jax(args):
    assert tfusion.fuse_template_pca(*args) == jfusion.fuse_template_pca(*args)
    assert tfusion.UNKNOWN == jfusion.UNKNOWN == "unknown"


def test_arbitration_dual_model_and_annotation_filter_match_jax():
    for w, h, conf in ((128, 128, 0.9), (300, 250, 0.2), (40, 60, 1.0)):
        assert tfusion.arbitration_score(w, h, conf) == jfusion.arbitration_score(w, h, conf)
    results = [(1, "dark", 0.6), (2, "light", 0.8), (3, "late", 0.8)]
    assert tfusion.dual_model_or(results) == jfusion.dual_model_or(results) == (2, "light", 0.8)
    assert tfusion.dual_model_or([]) == (-1, "unknown", 0.0)
    for case in (("unknown", 0.2, 300, 300), ("ann", 0.2, 300, 300), ("ann", 0.9, 150, 300)):
        assert tfusion.annotation_filter(*case) == jfusion.annotation_filter(*case)
