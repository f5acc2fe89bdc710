"""Port parity: ``detect/template.py`` against the JAX package -- the
bank's arrays, the validity masks, and both engines' detections on
planted frames with a bank of two native sizes."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.config import DetectConfig as JDetectConfig
from face_detection_recognization_pca_tpu.detect import template as jtpl
from face_detection_recognization_pca_tpu_torch.config import DetectConfig
from face_detection_recognization_pca_tpu_torch.detect import template as ttpl

torch.set_num_threads(1)

CPU = torch.device("cpu")
CANON = (48, 48)
# NCC values <= 1; float32 FFTs and window sums in other orders.
CONF_ATOL = 1e-4


def _face(person, side, rng):
    yy, xx = np.mgrid[0:side, 0:side] / side
    img = 128 + 55 * np.sin(6.28 * ((1.3 + person) * yy + 0.4 * person * xx)) \
        + 45 * np.cos(6.28 * (3.1 - person) * xx)
    return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def scene():
    """Templates: person ``ann`` at 48 x 48 (the canonical size: ratio 1)
    and person ``bob`` at 72 x 72 (ratio 1.5), two noisy copies each, so
    the bank holds two ratio groups.  Frames of 300 x 400:

    0: ann's face at (y, x) = (120, 150) with noise, and an exact copy at
       (4, 6), inside the border strip, whose higher score must fall
       through to the interior; bob's face at (150, 280).
    1: bob's face only, at (60, 90).
    2: noise only.
    """
    rng = np.random.default_rng(21)
    ann, bob = _face(0, 48, rng), _face(1, 72, rng)

    def noisy(face):
        return np.clip(face + rng.normal(0, 5, face.shape), 0, 255).astype(np.uint8)

    templates = [("bob", noisy(bob)), ("ann", noisy(ann)), ("ann", noisy(ann)), ("bob", noisy(bob))]
    frames = rng.integers(70, 180, (3, 300, 400)).astype(np.uint8)
    frames[0, 120:168, 150:198] = noisy(ann)
    frames[0, 4:52, 6:54] = templates[1][1]
    frames[0, 150:222, 280:352] = bob
    frames[1, 60:132, 90:162] = bob
    return templates, frames


def _same_detections(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert isinstance(a, ttpl.Detection)
        assert (a.x, a.y, a.width, a.height, a.person_name) == \
            (b.x, b.y, b.width, b.height, b.person_name)
        assert a.scale == pytest.approx(b.scale, abs=1e-12)
        assert abs(a.confidence - b.confidence) <= CONF_ATOL
        assert all(type(v) is int for v in (a.x, a.y, a.width, a.height))


def test_template_bank_holds_the_jax_banks_arrays(scene):
    templates, _ = scene
    jbank = jtpl.TemplateBank(templates, CANON)
    tbank = ttpl.TemplateBank(templates, CANON, device=CPU)
    assert tbank.person_names == jbank.person_names == ["ann", "bob"]
    assert tbank.person_index == jbank.person_index
    assert tbank.canonical.dtype == torch.float32
    np.testing.assert_array_equal(tbank.canonical.numpy(), np.asarray(jbank.canonical))  # bit for bit
    np.testing.assert_array_equal(tbank.template_person.numpy(), np.asarray(jbank.template_person))
    np.testing.assert_array_equal(tbank.native_ratios, jbank.native_ratios)
    assert tbank.native_ratios.tolist() == [1.5, 1.0, 1.0, 1.5]
    assert tbank.native_scale == jbank.native_scale == 1.25
    # Canonical-sized inputs with their native sizes given, as a decoder
    # that resizes hands them over.
    canon = [(n, np.asarray(c).astype(np.uint8)) for (n, _), c in zip(templates, jbank.canonical)]
    sizes = [t.shape for _, t in templates]
    np.testing.assert_array_equal(
        ttpl.TemplateBank(canon, CANON, native_sizes=sizes, device=CPU).native_ratios,
        jtpl.TemplateBank(canon, CANON, native_sizes=sizes).native_ratios,
    )
    # No canonical size: a parity-only bank.
    plain = ttpl.TemplateBank(templates, None, device=CPU)
    assert plain.canonical is None and plain.native_ratios is None and plain.native_scale == 1.0
    with pytest.raises(ValueError, match="no canonical"):
        ttpl.TemplateDetector(plain).detect_fused_batch(np.zeros((1, 100, 100), np.uint8))


@pytest.mark.parametrize(
    "key",
    [(253, 353, 48, 48, 400, 300, 0.15, 0.05, 1.0),
     (120, 175, 86, 86, 400, 300, 0.15, 0.05, 1.8),
     (328, 453, 38, 38, 400, 300, 0.15, 0.05, 0.8),
     (90, 130, 64, 40, 333, 217, 0.2, 0.1, 1.37)],
)
def test_validity_mask_matches_jax(key):
    got = ttpl._validity_mask(*key)
    np.testing.assert_array_equal(got, jtpl._validity_mask(*key))
    assert got.dtype == bool and 0 < got.sum() < got.size
    dev = ttpl._validity_mask_device(CPU, *key)
    assert dev is ttpl._validity_mask_device(CPU, *key)  # cached per (device, geometry)
    np.testing.assert_array_equal(dev.numpy(), got)


def test_fused_score_maps_match_jax(scene):
    templates, frames = scene
    tbank = ttpl.TemplateBank(templates, CANON, device=CPU)
    t0 = tbank.canonical - tbank.canonical.mean(dim=(1, 2), keepdim=True)
    energy = (t0 * t0).sum(dim=(1, 2))
    f = frames[:2].astype(np.float32)
    ref = np.asarray(jtpl._fused_score_maps(jnp.asarray(f), jnp.asarray(t0.numpy()),
                                            jnp.asarray(energy.numpy()), 48, 48))
    got = ttpl._fused_score_maps(torch.from_numpy(f), t0, energy, 48, 48)
    assert got.shape == ref.shape == (2, 4, 253, 353)
    np.testing.assert_allclose(got.numpy(), ref, atol=CONF_ATOL)
    assert float(got.max()) <= 1.0 and float(got.min()) >= -1.0
    # A flat region (per-pixel std below one gray level) scores exactly 0.
    f[0, :100, :100] = 90.0
    flat = ttpl._fused_score_maps(torch.from_numpy(f), t0, energy, 48, 48)[0, :, :53, :53]
    assert torch.all(flat == 0)


def test_detect_fused_batch_matches_jax(scene):
    templates, frames = scene
    jdet = jtpl.TemplateDetector(jtpl.TemplateBank(templates, CANON))
    tdet = ttpl.TemplateDetector(ttpl.TemplateBank(templates, CANON, device=CPU))
    ref = jdet.detect_fused_batch(frames)
    got = tdet.detect_fused_batch(frames)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _same_detections(g, r)
    # Frame 0: ann in the interior (the border copy fell through), and bob.
    by_name = {d.person_name: d for d in got[0]}
    assert (by_name["ann"].x, by_name["ann"].y, by_name["ann"].width) == (150, 120, 48)
    assert (by_name["bob"].x, by_name["bob"].y, by_name["bob"].width) == (280, 150, 72)
    assert by_name["bob"].scale == 1.5 and by_name["ann"].scale == 1.0
    assert [d.person_name for d in got[1]] == ["bob"] and got[2] == []
    # The two halves: scale slots equal to JAX's, and a packed tensor.
    jmeta, jpacked = jdet.detect_fused_device(frames)
    tmeta, tpacked = tdet.detect_fused_device(torch.from_numpy(frames))
    assert [(m.scale, m.box_w, m.box_h, m.rw, m.rh, m.tmpl.tolist()) for m in tmeta] == \
        [(m.scale, m.box_w, m.box_h, m.rw, m.rh, m.tmpl.tolist()) for m in jmeta]
    # Two ratio groups x three scales; 1.2 x 48 and 0.8 x 72 both search
    # 57 px boxes and share a slot, where all four templates compete.
    assert [m.box_w for m in tmeta] == [38, 48, 57, 72, 86]
    assert tmeta[2].tmpl.all() and tmeta[0].tmpl.tolist() == [False, True, True, False]
    assert tuple(tpacked.shape) == np.asarray(jpacked).shape == (5, 3, 3, 4)
    np.testing.assert_array_equal(tpacked[:, 1:].numpy(), np.asarray(jpacked)[:, 1:])  # x, y
    for g, r in zip(tdet.detect_fused_finish(tmeta, tpacked, 3), ref):
        _same_detections(g, r)
    # One frame alone gives what it gave in the batch.
    _same_detections(tdet.detect_fused(frames[0]), ref[0])
    assert tdet.detect_fused_finish([], None, 2) == [[], []]


def test_detect_fused_shares_a_slot_between_groups_of_one_box_size(scene):
    """Ratio groups whose scaled boxes coincide share one slot, and both
    groups' templates compete there."""
    templates, frames = scene
    cfg = dict(template_scales=(1.0, 1.5))
    jdet = jtpl.TemplateDetector(jtpl.TemplateBank(templates, CANON), JDetectConfig(**cfg))
    tdet = ttpl.TemplateDetector(ttpl.TemplateBank(templates, CANON, device=CPU),
                                 DetectConfig(**cfg))
    tmeta, _ = tdet.detect_fused_device(frames[:1])
    jmeta, _ = jdet.detect_fused_device(frames[:1])
    assert [(m.box_w, m.tmpl.tolist()) for m in tmeta] == [(m.box_w, m.tmpl.tolist()) for m in jmeta]
    assert [m.box_w for m in tmeta] == [48, 72, 108]
    assert tmeta[1].tmpl.all()  # 1.5 x 48 and 1.0 x 72
    for g, r in zip(tdet.detect_fused_batch(frames[:2]), jdet.detect_fused_batch(frames[:2])):
        _same_detections(g, r)


@pytest.mark.parametrize("frame_index", [0, 1, 2])
def test_detect_parity_matches_jax(scene, frame_index):
    templates, frames = scene
    jdet = jtpl.TemplateDetector(jtpl.TemplateBank(templates, CANON))
    tdet = ttpl.TemplateDetector(ttpl.TemplateBank(templates, CANON, device=CPU))
    ref = jdet.detect_parity(frames[frame_index])
    got = tdet.detect_parity(frames[frame_index])
    _same_detections(got, ref)
    names = sorted(d.person_name for d in got)
    if frame_index == 0:
        # ann's global peak is the border copy: the reference's loop drops
        # the candidate instead of falling through, so only bob is found.
        assert names == ["bob"]
        assert (got[0].x, got[0].y, got[0].width, got[0].scale) == (280, 150, 72, 1.0)
    assert names == [["bob"], ["bob"], []][frame_index]
    # A tensor frame gives the same as the numpy frame.
    _same_detections(tdet.detect_parity(torch.from_numpy(frames[frame_index])), got)


def test_nms_across_persons_keeps_the_best_of_overlapping_boxes(scene):
    templates, _ = scene
    tdet = ttpl.TemplateDetector(ttpl.TemplateBank(templates, CANON, device=CPU))
    jdet = jtpl.TemplateDetector(jtpl.TemplateBank(templates, CANON))
    boxes = [(10, 10, 50, 50, 0.8, "ann"), (12, 11, 50, 50, 0.9, "bob"), (200, 100, 50, 50, 0.7, "cy"),
             (14, 12, 50, 50, 0.9, "dee")]
    got = tdet._nms([ttpl.Detection(*b) for b in boxes])
    ref = jdet._nms([jtpl.Detection(*b) for b in boxes])
    assert [d.person_name for d in got] == [d.person_name for d in ref] == ["bob", "cy"]
    assert tdet._nms(got[:1]) == got[:1]
