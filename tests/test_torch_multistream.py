"""Port parity for the slice: ``parallel/multistream.py`` against the JAX
``MultiStreamRecognizer`` at the size of ``tests/test_multistream.py``,
and the tracker workload of ``bench.py`` at a small size."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu import bench as jbench
from face_detection_recognization_pca_tpu.models import eigenfaces as jef
from face_detection_recognization_pca_tpu.parallel import multistream as jms
from face_detection_recognization_pca_tpu_torch import bench as tbench
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as tef
from face_detection_recognization_pca_tpu_torch.ops import fused_match as tfm
from face_detection_recognization_pca_tpu_torch.parallel import multistream as tms

torch.set_num_threads(1)

CPU = torch.device("cpu")
TPL, WIN, S, H, W = 64, 128, 8, 240, 320
# Float32 sums in other orders (the step's global mean, the DFT matmuls,
# the projection); scores are cosines and NCC values <= 1.
CONF_ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1234)
    yy, xx = np.mgrid[0:TPL, 0:TPL].astype(np.float32) / TPL
    face = (120 + 50 * np.sin(6.28 * yy * 1.7) + 35 * np.cos(6.28 * xx * 2.3)).astype(
        np.float32
    )
    gallery = np.stack(
        [
            np.roll(face, (int(rng.integers(-2, 3)), int(rng.integers(-2, 3))), (0, 1)).reshape(-1)
            + rng.normal(0, 2, TPL * TPL)
            for _ in range(32)
        ]
    ).astype(np.float32)
    jmodel, _ = jef.train_v1(jnp.asarray(gallery), n_components=8)
    # Labels other than the trainer's zeros, so person_id is checked too.
    jmodel = jmodel.replace(labels=jnp.asarray(np.arange(32, dtype=np.int32) % 4))
    params = {
        name: None if getattr(jmodel, name) is None else np.asarray(getattr(jmodel, name))
        for name in tef.PARAM_NAMES
    }
    tmodel = tef.from_params(params, jmodel.face_shape, jmodel.schema, CPU)
    return face, gallery, jmodel, tmodel


def _frames(face, rng, t):
    """(S, H, W) noise frames with the face planted at time step ``t``;
    returns the frames and the planted (y, x) per stream."""
    frames = rng.normal(100, 20, (S, H, W)).astype(np.float32)
    plants = np.array([(60 + 5 * i + 2 * t, 100 + 7 * i - t) for i in range(S)], np.int32)
    for i, (oy, ox) in enumerate(plants):
        frames[i, oy : oy + TPL, ox : ox + TPL] = face
    return frames, plants


def _assert_same(tout, jout):
    for key in ("gallery_row", "person_id", "x", "y"):
        assert tout[key].dtype == torch.int32, key
        np.testing.assert_array_equal(tout[key].numpy(), np.asarray(jout[key]), err_msg=key)
    for key in ("confidence", "template_confidence"):
        assert tout[key].dtype == torch.float32, key
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), rtol=0,
                                   atol=CONF_ATOL, err_msg=key)


def test_process_batch_and_window_match_jax(setup, rng):
    face, _, jmodel, tmodel = setup
    frames = [_frames(face, rng, t) for t in range(4)]
    jmsr = jms.MultiStreamRecognizer(jmodel, face, window=WIN)
    tmsr = tms.MultiStreamRecognizer(tmodel, face, window=WIN)

    # Two process_batch steps from centred windows, the state threaded.
    jstate = jmsr.init_state(S, (H, W))
    tstate = tmsr.init_state(S, (H, W))
    assert tstate.origin.dtype == torch.int32
    np.testing.assert_array_equal(tstate.origin.numpy(), np.asarray(jstate.origin))
    for f, plants in frames[:2]:
        jout, jstate = jmsr.process_batch(jnp.asarray(f), jstate)
        tout, tstate = tmsr.process_batch(torch.from_numpy(f), tstate)
        _assert_same(tout, jout)
        np.testing.assert_array_equal(tstate.origin.numpy(), np.asarray(jstate.origin))
        np.testing.assert_array_equal(tout["x"].numpy(), plants[:, 1])
        np.testing.assert_array_equal(tout["y"].numpy(), plants[:, 0])

    # One T = 4 window from boxes at the first plants.
    stack = np.stack([f for f, _ in frames])
    plants0 = frames[0][1]
    boxes = np.stack([plants0[:, 1], plants0[:, 0], np.full(S, TPL), np.full(S, TPL)], 1)
    jout, jstate = jmsr.process_window(jnp.asarray(stack), jmsr.init_state(S, (H, W), boxes))
    tout, tstate = tmsr.process_window(torch.from_numpy(stack),
                                       tmsr.init_state(S, (H, W), boxes))
    assert tout["x"].shape == (4, S)
    _assert_same(tout, jout)
    np.testing.assert_array_equal(tstate.origin.numpy(), np.asarray(jstate.origin))
    np.testing.assert_array_equal(tout["x"].numpy(), np.stack([p[:, 1] for _, p in frames]))


def test_port_trained_model_locks_on_exactly(setup, rng):
    """A model trained by the port's own train_v1, with the exact face as
    gallery row 0, finds every plant and names row 0."""
    face, gallery, _, _ = setup
    images = gallery.copy()
    images[0] = face.reshape(-1)
    model, _ = tef.train_v1(torch.from_numpy(images), n_components=8)
    msr = tms.MultiStreamRecognizer(model, face, window=WIN)
    frames = [_frames(face, rng, t) for t in range(3)]
    state = msr.init_state(S, (H, W))
    outs = []
    for f, _ in frames:
        out, state = msr.process_batch(torch.from_numpy(f), state)
        outs.append(out)
    assert tbench.planted_exact(outs, np.stack([p for _, p in frames]))
    assert min(float(o["confidence"].min()) for o in outs) > 0.999


def test_tracker_assets_match_jax():
    streams, size, batches = 2, (480, 640), 2
    jframes, jlin, jface, jplants = jbench._tracker_assets(streams, size, batches, 4)
    frames, gallery_images, face, plants = tbench.tracker_assets(streams, size, batches, 4, CPU)
    np.testing.assert_array_equal(face, jface)
    np.testing.assert_array_equal(plants, jplants)
    np.testing.assert_allclose(gallery_images.mean(0).numpy(), np.asarray(jlin["mean"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(gallery_images[0].numpy(), face.reshape(-1))
    assert frames.shape == (batches, streams, *size) and frames.dtype == torch.float32
    for f in range(batches):
        for s in range(streams):
            y, x = plants[f, s]
            np.testing.assert_array_equal(frames[f, s, y : y + 96, x : x + 96].numpy(), face)
    # The noise is the port's own (a torch.Generator), with the JAX moments;
    # rows above the 192 px margin hold no plant.
    noise = frames[..., :192, :]
    assert abs(float(noise.mean()) - 110) < 0.2 and abs(float(noise.std()) - 25) < 0.2


def test_slice_is_planted_exact_at_a_small_size():
    """The chip smoke test's slice, cut to 3 streams of 480x640 on the CPU:
    tracker_assets, train_v1, then process_batch and process_window from
    the planted first boxes."""
    streams, (h, w), batches = 3, (480, 640), 3
    frames, gallery_images, face, plants = tbench.tracker_assets(
        streams, (h, w), batches, 4, CPU
    )
    model, _ = tef.train_v1(gallery_images, n_components=tbench.N_COMPONENTS)
    model.labels = torch.arange(tbench.GALLERY_N, dtype=torch.int32) % 4
    msr = tms.MultiStreamRecognizer(model, face, window=tbench.WIN)
    boxes0 = np.stack(
        [plants[0, :, 1], plants[0, :, 0], np.zeros(streams), np.zeros(streams)], 1
    ).astype(np.int32)
    launches = tfm.fused_match.launches
    state = msr.init_state(streams, (h, w), boxes0)
    outs = []
    for f in range(batches):
        out, state = msr.process_batch(frames[f], state)
        outs.append(out)
    wout, wstate = msr.process_window(frames, msr.init_state(streams, (h, w), boxes0))
    assert tbench.planted_exact(outs, plants)
    assert tbench.planted_exact(wout, plants)
    assert torch.equal(state.origin, wstate.origin)
    assert (wout["person_id"] == 0).all()
    assert tfm.fused_match.launches == launches  # CPU tensors take the plain path
    wrong = plants.copy()
    wrong[1, 2, 0] += 1
    assert not tbench.planted_exact(wout, wrong)
