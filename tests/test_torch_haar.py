"""Port parity for the Haar cascade detector: the parsed cascade, the
level plan, ``group_rectangles``, the accept sets against an independent
float64 numpy cascade and the JAX program, and the grouped boxes against
the JAX ``HaarDetector``, all on seeded frames that hold the synthetic
face of ``bench.haar_face``.

Every JAX detector call uses one frame size (180 x 240) and is made once,
in a module fixture: XLA compiles its chunk programs per frame size, which
takes minutes on a CPU."""

import dataclasses
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu.detect import haar as jhaar
from face_detection_recognization_pca_tpu_torch import bench
from face_detection_recognization_pca_tpu_torch.detect import haar as thaar
from face_detection_recognization_pca_tpu_torch.io import native
from face_detection_recognization_pca_tpu_torch.ops.resize import resize_bilinear
from haar_scenes import frames180, numpy_cascade_accepts, numpy_cascade_margins, scene

torch.set_num_threads(1)

CPU = torch.device("cpu")
SYSTEM_XML = "/usr/share/opencv4/haarcascades/haarcascade_frontalface_default.xml"
PACKAGED_XML = thaar.PACKAGED_CASCADE


@pytest.fixture(scope="module")
def cascades():
    """(JAX package's, port's) parse of the packaged XML."""
    return jhaar.load_cascade(PACKAGED_XML), thaar.load_cascade(PACKAGED_XML)


@pytest.fixture(scope="module")
def detector(cascades):
    return thaar.HaarDetector(cascades[1], device=CPU)


@pytest.fixture(scope="module")
def frames():
    return frames180()


@pytest.fixture(scope="module")
def jax_boxes(cascades, frames):
    """min_neighbors -> the JAX detector's boxes per frame of ``frames``."""
    det = jhaar.HaarDetector(cascades[0])
    return {mn: det.detect_multi_scale_batch(frames, 1.1, mn, (30, 30)) for mn in (0, 5)}


# ---------------------------------------------------------------------------
# Host half
# ---------------------------------------------------------------------------


def test_packaged_cascade_is_opencvs_file():
    assert thaar.DEFAULT_CASCADE_PATHS[:2] == jhaar.DEFAULT_CASCADE_PATHS
    assert thaar.DEFAULT_CASCADE_PATHS[-1] == PACKAGED_XML and os.path.exists(PACKAGED_XML)
    digest = hashlib.sha256(open(PACKAGED_XML, "rb").read()).hexdigest()
    assert digest == "0f7d4527844eb514d4a4948e822da90fbb16a34a0bbbbc6adc6498747a5aafb0"
    assert os.path.getsize(PACKAGED_XML) == 930127
    if os.path.exists(SYSTEM_XML):
        assert hashlib.sha256(open(SYSTEM_XML, "rb").read()).hexdigest() == digest
    assert os.path.exists(thaar.find_cascade())


def test_load_cascade_equals_jax(cascades, tmp_path):
    jc, tc = cascades
    assert tc.window_size == jc.window_size == (24, 24)
    assert tc.n_stages == jc.n_stages == 25 and tc.n_stumps == jc.n_stumps == 2913
    for field in dataclasses.fields(jc):
        a, b = getattr(jc, field.name), getattr(tc, field.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
    # With no path, the first of the default paths that exists is read.
    np.testing.assert_array_equal(thaar.load_cascade().corner_matrix, tc.corner_matrix)
    bad = tmp_path / "other.xml"
    bad.write_text("<opencv_storage><other/></opencv_storage>")
    with pytest.raises(ValueError, match="not a new-format cascade"):
        thaar.load_cascade(str(bad))


@pytest.mark.parametrize("size", [(544, 960), (1080, 1920), (180, 240)])
@pytest.mark.parametrize("scale_factor", [1.1, 1.25])
@pytest.mark.parametrize("min_size", [(30, 30), (24, 24)])
def test_pyramid_levels_equal_jax(size, scale_factor, min_size):
    h, w = size
    for max_size in (None, (120, 120)):
        got = thaar._pyramid_levels(h, w, (24, 24), scale_factor, min_size, max_size)
        assert got == jhaar._pyramid_levels(h, w, (24, 24), scale_factor, min_size, max_size)
        assert got and all(step == (1 if factor > 2.0 else 2) for factor, _, _, step in got)
        if max_size:
            assert max(int(round(24 * lv[0])) for lv in got) <= 120
    assert thaar._pyramid_levels(24, 24, (24, 24), 1.1, (30, 30), None) == []


def _cloud(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 160))
    centres = rng.integers(0, 300, (int(rng.integers(1, 6)), 2))
    c = centres[rng.integers(0, len(centres), n)]
    size = rng.integers(24, 120, n)
    return [(int(cx + rng.integers(-15, 16)), int(cy + rng.integers(-15, 16)), int(s), int(s))
            for (cx, cy), s in zip(c, size)]


@pytest.mark.parametrize("seed", range(6))
def test_group_rectangles_equals_jax_on_clouds(seed):
    """Clusters of rectangles around a few centres: both routes of the port
    give the JAX package's Python route's boxes, order included."""
    rects = _cloud(seed)
    for threshold in (1, 3, 5):
        want = jhaar._group_rectangles_py(rects, threshold, 0.2)
        assert thaar._group_rectangles_py(rects, threshold, 0.2) == want
        assert thaar.group_rectangles(rects, threshold, 0.2) == want
        assert jhaar.group_rectangles(rects, threshold, 0.2) == want
        got_native = native.group_rectangles_native(rects, threshold, 0.2)
        assert got_native is None or got_native == want


@pytest.mark.parametrize("route", ["dispatch", "python"])
def test_group_rectangles_semantics(route):
    group = thaar.group_rectangles if route == "dispatch" else thaar._group_rectangles_py
    # 6 near-identical rects + 1 outlier, threshold 5 like the reference.
    base = [(100 + i, 100 - i, 50, 50) for i in range(6)]
    outlier = [(300, 300, 60, 60)]
    out = group(base + outlier, 5)
    assert out == jhaar._group_rectangles_py(base + outlier, 5) and len(out) == 1
    x, y, w, h = out[0]
    assert abs(x - 102) <= 2 and abs(y - 98) <= 2 and abs(w - 50) <= 1
    # Threshold 0 returns everything ungrouped, in the order given.
    assert group(base + outlier, 0) == base + outlier
    # Clusters with exactly threshold members are dropped (strict >).
    assert group(base, 6) == []
    assert group([], 3) == []
    # A small cluster inside a bigger, stronger one is rejected.
    big = [(100, 100, 100, 100)] * 8
    small = [(130, 130, 30, 30)] * 4
    assert group(big + small, 3) == jhaar._group_rectangles_py(big + small, 3) == [
        (100, 100, 100, 100)]


def test_group_rectangles_falls_back_where_the_native_library_is_absent(monkeypatch):
    rects = _cloud(3)
    want = thaar._group_rectangles_py(rects, 3, 0.2)
    monkeypatch.setattr(native, "group_rectangles_native", lambda *a: None)
    assert thaar.group_rectangles(rects, 3, 0.2) == want


# ---------------------------------------------------------------------------
# The synthetic face
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("person", [0, 1, 2, 3])
def test_haar_face_passes_the_numpy_cascade(cascades, person):
    """At the base size the face's own window passes all 25 stages of the
    float64 numpy cascade with room to spare, and so do windows 2 px off:
    a change to the recipe cannot pass unseen."""
    patch = bench.haar_face(24, person)
    assert patch.shape == (30, 30) and patch.dtype == np.uint8
    margins = numpy_cascade_margins(patch, cascades[1], step=1)  # (7, 7) windows
    assert margins[3, 3] > 0.5, margins[3, 3]
    assert (margins[1:6, 1:6] >= 0).sum() >= 15
    if person:
        plain = bench.haar_face(24).astype(int)
        diff = np.abs(patch.astype(int) - plain)
        assert 0 < diff.max() <= 3 * bench.HAAR_TEXTURE_LEVELS + 1
    # The nominal face is the middle of the patch, whatever the side.
    big = bench.haar_face(96, person)
    assert big.shape == (120, 120)


def test_haar_assets_plant_one_face_per_frame():
    frames, plants = bench.haar_assets(3, (300, 400), 5, CPU)
    assert frames.shape == (3, 300, 400) and frames.dtype == torch.float32 and len(plants) == 3
    bgr, plants_b = bench.haar_bgr_frames(3, (300, 400), 5, persons=(1, 2))
    assert bgr.shape == (3, 300, 400, 3) and bgr.dtype == np.uint8
    for (y, x, patch, side), frame in zip(plants_b, bgr):
        assert 60 <= side <= 220 and patch == round(1.25 * side)
        assert 8 <= y and y + patch <= 300 - 8 and 8 <= x and x + patch <= 400 - 8
        assert np.array_equal(frame[..., 0], frame[..., 1])
    np.testing.assert_array_equal(bgr[1, plants_b[1][0]:, plants_b[1][1]:, 0][:10, :10],
                                  bench.haar_face(int(plants_b[1][3]), 2)[:10, :10])
    # The tolerance that names a planted face.
    y, x, patch, side = (int(v) for v in plants_b[0])
    box = (x + (patch - side) // 2, y + (patch - side) // 2, side, side)
    assert bench.haar_planted_boxes([box, (0, 0, side, side)], plants_b[0]) == [box]
    assert bench.haar_planted_boxes([(box[0], box[1], 2 * side, 2 * side)], plants_b[0]) == []


# ---------------------------------------------------------------------------
# Accept sets
# ---------------------------------------------------------------------------


def test_accept_sets_equal_numpy_cascade_and_jax(cascades, detector):
    """One 96 x 128 frame holding a 24 px and a 48 px face, on the levels
    where they sit (factor 1, stride 2; factor 1.1^8, stride 1): the
    port's accepted (level, x, y) equal the float64 numpy cascade's on the
    port's own resized level, and the JAX program's, exactly."""
    jc, tc = cascades
    rng = np.random.default_rng(5)
    frame = scene((96, 128), [(6, 8, 24, 0), (30, 56, 48, 0)], (88, 6), rng)
    factor = 1.1 ** 8
    levels = [(1.0, 96, 128, 2), (factor, round(96 / factor), round(128 / factor), 1)]
    assert levels[1][1:] == (45, 60, 1)

    handle = {"survivors": [], "windows": 0}
    rows = detector._accepted_windows(
        torch.from_numpy(frame[None].astype(np.float32)), levels, handle).numpy()
    got = {(int(lv), int(x), int(y)) for _, lv, y, x in rows}
    assert handle["windows"] == 37 * 53 + 22 * 37

    want = set()
    for li, (_, sh, sw, step) in enumerate(levels):
        level = frame.astype(np.float32) if li == 0 else resize_bilinear(
            torch.from_numpy(frame.astype(np.float32)), (sw, sh)).numpy()
        want |= {(li, x, y) for x, y in numpy_cascade_accepts(level, tc, step)}
    assert {lv for lv, _, _ in want} == {0, 1}, "each face is accepted on its level"
    assert got == want

    fn_one, _ = jhaar._make_pyramid_fn(jc, tuple(levels), prefilter_stages=5)
    ok, cx, cy, lid, _, _ = (np.asarray(a)[0] for a in fn_one(
        jnp.asarray(frame.astype(np.float32))))
    assert got == {(int(l), int(x), int(y)) for o, x, y, l in zip(ok, cx, cy, lid) if o}


# ---------------------------------------------------------------------------
# Boxes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("min_neighbors", [5, 0])
def test_boxes_equal_jax(detector, frames, jax_boxes, min_neighbors):
    """Grouped boxes (5) and raw rectangles (0) equal the JAX detector's,
    order included, on every frame."""
    got = detector.detect_multi_scale_batch(frames, 1.1, min_neighbors, (30, 30))
    assert got == jax_boxes[min_neighbors]
    assert [len(g) for g in got][2] == (0 if min_neighbors else len(got[2]))
    if min_neighbors:
        # One face; two faces; noise; a face cut by the border (found: its
        # box still fits the frame).
        assert [len(g) for g in got] == [1, 2, 0, 1]
        assert len(bench.haar_planted_boxes(got[0], (30, 60, 90, 72))) == 1
        assert len(bench.haar_planted_boxes(got[1], (10, 10, 60, 48))) == 1
        assert len(bench.haar_planted_boxes(got[1], (60, 110, 110, 88))) == 1
        for x, y, w, h in got[3]:
            assert x + w <= 240 and y + h <= 180


def test_batch_equals_single_and_input_types(detector, frames):
    batch = detector.detect_multi_scale_batch(frames)
    for frame, want in zip(frames, batch):
        assert detector.detect_multi_scale(frame) == want
    assert detector.detect_multi_scale_batch(torch.from_numpy(frames)) == batch
    assert detector.detect_multi_scale_batch(frames.astype(np.float32)) == batch
    assert detector.detect_multi_scale(torch.from_numpy(frames[1]).to(torch.float64)) == batch[1]


def test_pipelined_equals_blocking(detector, frames):
    """Device halves issued ahead of their host halves give what the
    blocking call gives, and a handle reports the funnel."""
    want = [detector.detect_multi_scale_batch(frames[i:i + 2], 1.1, 3) for i in (0, 2)]
    handles = [detector.detect_device(frames[i:i + 2], 1.1, 3) for i in (0, 2)]
    assert [detector.detect_finish(h) for h in handles] == want
    h = handles[0]
    assert h["frames"] == 2 and len(h["levels"]) == len(
        thaar._pyramid_levels(180, 240, (24, 24), 1.1, (30, 30), None))
    stages = [s for s, _ in h["survivors"]]
    counts = [n for _, n in h["survivors"]]
    assert stages[0] == detector.dense_stages and stages[-1] == 25
    assert counts == sorted(counts, reverse=True) and counts[0] < 2 * h["windows"]
    assert counts[-1] == len(h["rows"]) == sum(
        len(r) for r in detector.detect_multi_scale_batch(frames[:2], 1.1, 0))


@pytest.mark.parametrize("dense_stages", [1, 2, 5, 9])
def test_result_does_not_depend_on_the_dense_boundary(cascades, detector, frames, dense_stages):
    other = thaar.HaarDetector(cascades[1], device=CPU, dense_stages=dense_stages)
    assert other.dense_stages == dense_stages != detector.dense_stages
    for mn in (0, 5):
        assert other.detect_multi_scale_batch(frames, 1.1, mn) == \
            detector.detect_multi_scale_batch(frames, 1.1, mn)


def test_blocks_larger_than_the_limit_are_sliced(cascades, detector, frames, monkeypatch):
    want = detector.detect_multi_scale_batch(frames[:2], 1.1, 0)
    monkeypatch.setattr(thaar, "_MAX_BLOCK_VALUES", 50_000)
    assert detector.detect_multi_scale_batch(frames[:2], 1.1, 0) == want


def test_no_faces_on_blank_and_noise(detector):
    rng = np.random.default_rng(1234)
    blank = np.full((240, 320), 128, dtype=np.uint8)
    assert detector.detect_multi_scale(blank, 1.1, 5, (30, 30)) == []
    noise = rng.integers(0, 256, (240, 320), dtype=np.uint8)
    assert detector.detect_multi_scale(noise, 1.1, 5, (30, 30)) == []


def test_size_limits_and_frames_too_small(detector, frames):
    faces = detector.detect_multi_scale(frames[1], 1.1, 3, (70, 70))
    assert faces and all(w >= 70 and h >= 70 for _, _, w, h in faces)
    small = detector.detect_multi_scale(frames[1], 1.1, 3, (30, 30), (70, 70))
    assert small and all(w <= 70 and h <= 70 for _, _, w, h in small)
    # No level's window is 70 px, so the two limits split the raw rectangles.
    raw = [detector.detect_multi_scale(frames[1], 1.1, 0, *limits)
           for limits in (((70, 70),), ((30, 30), (70, 70)), ())]
    assert raw[0] and raw[1] and sorted(raw[0] + raw[1]) == sorted(raw[2])
    # No level fits: no device work, an empty list per frame.
    handle = detector.detect_device(np.zeros((3, 20, 20), np.uint8))
    assert handle["rows"] is None and detector.detect_finish(handle) == [[], [], []]
    assert detector.detect_multi_scale_batch(frames[:1], 1.1, 5, (400, 400)) == [[]]


def test_device_none_needs_cuda(cascades):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            thaar.HaarDetector(cascades[1])


# ---------------------------------------------------------------------------
# A larger frame
# ---------------------------------------------------------------------------

# The raw windows at 544p on which the two packages differ, per frame: the
# port's own, and the JAX package's own.  The float64 numpy cascade takes
# the port's and refuses the JAX package's: that package sums its level
# integrals in float32, whose totals pass 2^24 on a 544 x 960 level.
RAW_544P_PORT_ONLY = [[(335, 242, 32, 32), (403, 175, 91, 91)], [(615, 410, 32, 32)]]
RAW_544P_JAX_ONLY = [[], [(729, 243, 35, 35)]]


@pytest.mark.slow
def test_raw_windows_at_544p_follow_the_float64_cascade(cascades, capsys):
    """Two 544 x 960 frames of ``bench.haar_bgr_frames(2, (544, 960), 21)``:
    the grouped boxes (minNeighbors 5) equal the JAX detector's; the raw
    windows (minNeighbors 0) equal, as a set and in order, those the float64
    numpy cascade accepts on the port's own levels, scaled to the frame as
    ``detect_finish`` scales them; and the windows where the JAX detector
    differs are listed."""
    jc, tc = cascades
    bgr, _ = bench.haar_bgr_frames(2, (544, 960), 21)
    gray = bgr[..., 0].astype(np.float32)
    det = thaar.HaarDetector(tc, device=CPU)
    jdet = jhaar.HaarDetector(jc)
    got = {mn: det.detect_multi_scale_batch(gray, 1.1, mn, (30, 30)) for mn in (5, 0)}
    want = {mn: jdet.detect_multi_scale_batch(gray, 1.1, mn, (30, 30)) for mn in (5, 0)}
    assert got[5] == want[5] and [len(g) for g in got[5]] == [1, 1]

    levels = thaar._pyramid_levels(544, 960, tc.window_size, 1.1, (30, 30), None)
    wh, ww = tc.window_size
    for b in range(2):
        frame = torch.from_numpy(gray[b:b + 1])
        boxes = []
        for factor, sh, sw, step in levels:
            level = frame if (sh, sw) == (544, 960) else resize_bilinear(frame, (sw, sh))
            # np.rint rounds half to even, as detect_finish does.
            for x, y in sorted(numpy_cascade_accepts(level[0].numpy(), tc, step),
                               key=lambda p: (p[1], p[0])):
                boxes.append((int(np.rint(x * factor)), int(np.rint(y * factor)),
                              int(np.rint(ww * factor)), int(np.rint(wh * factor))))
        assert got[0][b] == boxes, b
        port_only = [r for r in got[0][b] if r not in want[0][b]]
        jax_only = [r for r in want[0][b] if r not in got[0][b]]
        with capsys.disabled():
            print(f"\nframe {b}: {len(got[0][b])} raw windows in the port, {len(want[0][b])} in "
                  f"the JAX package; port only {port_only}, JAX only {jax_only}")
        assert port_only == RAW_544P_PORT_ONLY[b] and jax_only == RAW_544P_JAX_ONLY[b]
