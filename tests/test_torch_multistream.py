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
from face_detection_recognization_pca_tpu_torch import device as tdevice
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as tef
from face_detection_recognization_pca_tpu_torch.ops import fused_match as tfm
from face_detection_recognization_pca_tpu_torch.parallel import mesh as tmesh
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


def test_k300_model_matches_jax(setup, rng):
    """A model with 300 components, past the 256 of one kernel chunk: the
    JAX tracker recognizes it inline, and the port's fused_match must
    take it too.  Carried over with from_params; same frames, both paths."""
    face, gallery, _, _ = setup
    k, d = 300, TPL * TPL
    comps = np.linalg.qr(rng.normal(size=(d, k)))[0].T.astype(np.float32)
    pmean = gallery.mean(0).astype(np.float32)
    jmodel = jef.EigenfacesModel(
        components=jnp.asarray(comps),
        projection_mean=jnp.asarray(pmean),
        mean_face=jnp.asarray(pmean),
        gallery=jnp.asarray(((gallery - pmean) @ comps.T).astype(np.float32)),
        labels=jnp.asarray(np.arange(32, dtype=np.int32) % 4),
        face_shape=(TPL, TPL),
        schema="v1",
    )
    params = {
        name: None if getattr(jmodel, name) is None else np.asarray(getattr(jmodel, name))
        for name in tef.PARAM_NAMES
    }
    tmodel = tef.from_params(params, jmodel.face_shape, jmodel.schema, CPU)
    assert tmodel.n_components == 300
    jmsr = jms.MultiStreamRecognizer(jmodel, face, window=WIN)
    tmsr = tms.MultiStreamRecognizer(tmodel, face, window=WIN)
    frames = [_frames(face, rng, t) for t in range(2)]
    jstate, tstate = jmsr.init_state(S, (H, W)), tmsr.init_state(S, (H, W))
    for f, plants in frames:
        jout, jstate = jmsr.process_batch(jnp.asarray(f), jstate)
        tout, tstate = tmsr.process_batch(torch.from_numpy(f), tstate)
        _assert_same(tout, jout)
        np.testing.assert_array_equal(tout["y"].numpy(), plants[:, 0])
    stack = np.stack([f for f, _ in frames])
    jout, _ = jmsr.process_window(jnp.asarray(stack), jmsr.init_state(S, (H, W)))
    tout, _ = tmsr.process_window(torch.from_numpy(stack), tmsr.init_state(S, (H, W)))
    _assert_same(tout, jout)


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


def _uneven_frames(face, rng, t):
    """:func:`_frames` with stream i's noise level raised by 12 i, so the
    window means differ per stream by far more than the NCC tolerates: a
    mean taken per shard would change the scores."""
    frames, plants = _frames(face, rng, t)
    frames = frames + (12.0 * np.arange(S, dtype=np.float32))[:, None, None]
    for i, (oy, ox) in enumerate(plants):
        frames[i, oy : oy + TPL, ox : ox + TPL] = face
    return frames, plants


@pytest.mark.parametrize("data", [8, 4, 2])
def test_mesh_gives_the_same_bits_as_no_mesh(setup, rng, data):
    """S = 8 streams over a ``(data, 1)`` mesh of CPU devices, three frames
    through ``process_window`` and one through ``process_batch``: every
    result and the carried origins equal the no-mesh run bit for bit.

    One exception, on the CPU only: with one stream per shard (data = 8)
    the plain version of the fused kernel computes its projection as a
    matrix-vector product, which sums in another order than the
    matrix-matrix product of a larger batch, so ``confidence`` is held to
    2 ulp of 1 there and to the same bits on the other meshes.  The
    template scores, which the mean of the windows enters, are the same
    bits on every mesh."""
    face, _, _, tmodel = setup
    frames = [_uneven_frames(face, rng, t) for t in range(3)]
    stack = torch.from_numpy(np.stack([f for f, _ in frames]))
    plain = tms.MultiStreamRecognizer(tmodel, face, window=WIN)
    mesh = tmesh.make_mesh(data, 1, devices=["cpu"] * 8)
    meshed = tms.MultiStreamRecognizer(tmodel, face, window=WIN, mesh=mesh)
    assert meshed.device == torch.device("cpu")

    # The windows' means differ per stream: what a per-shard mean would see.
    windows = tms.slice_windows(stack[0], plain.init_state(S, (H, W)).origin, WIN)
    per_stream = windows.mean(dim=(1, 2))
    assert float(per_stream.max() - per_stream.min()) > 50

    want, want_state = plain.process_window(stack, plain.init_state(S, (H, W)))
    got, got_state = meshed.process_window(stack, meshed.init_state(S, (H, W)))
    one_want, _ = plain.process_batch(stack[0], plain.init_state(S, (H, W)))
    one_got, _ = meshed.process_batch(stack[0], meshed.init_state(S, (H, W)))
    for w, g in ((want, got), (one_want, one_got)):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
            if key == "confidence" and data == S:
                np.testing.assert_allclose(g[key].numpy(), w[key].numpy(), rtol=0, atol=2.4e-7)
            else:
                assert torch.equal(g[key], w[key]), key
    assert torch.equal(got_state.origin, want_state.origin)
    np.testing.assert_array_equal(got["x"].numpy(), np.stack([p[:, 1] for _, p in frames]))
    np.testing.assert_array_equal(got["y"].numpy(), np.stack([p[:, 0] for _, p in frames]))

    with pytest.raises(ValueError, match="not divisible"):
        meshed.process_batch(stack[0, : S - 1], meshed.init_state(S - 1, (H, W)))


def test_mesh_matches_jax_mesh(setup, rng):
    """The JAX recognizer over its (8, 1) mesh of fake CPU devices against
    the port's over its own, on the uneven frames."""
    import jax

    from face_detection_recognization_pca_tpu.parallel import mesh as jmesh

    if len(jax.devices()) < 8:
        pytest.skip("need 8 fake devices (xla_force_host_platform_device_count)")
    face, _, jmodel, tmodel = setup
    stack = np.stack([_uneven_frames(face, rng, t)[0] for t in range(2)])
    jmsr = jms.MultiStreamRecognizer(
        jmodel, face, window=WIN, mesh=jmesh.make_mesh(data=8, model=1, devices=jax.devices()[:8]))
    tmsr = tms.MultiStreamRecognizer(tmodel, face, window=WIN,
                                     mesh=tmesh.make_mesh(8, 1, devices=["cpu"] * 8))
    jout, jstate = jmsr.process_window(jnp.asarray(stack), jmsr.init_state(S, (H, W)))
    tout, tstate = tmsr.process_window(torch.from_numpy(stack), tmsr.init_state(S, (H, W)))
    _assert_same(tout, jout)
    np.testing.assert_array_equal(tstate.origin.numpy(), np.asarray(jstate.origin))


@pytest.mark.parametrize("entry", ["process_batch", "process_window"])
def test_steps_compute_in_full_float32_and_restore_the_flags(setup, rng, entry):
    """A caller under ``set_float32_matmul_precision("high")``: inside the
    step both TF32 switches are off, after it they are as the caller set
    them, and the results are those of a caller who never touched them."""
    face, _, _, tmodel = setup
    frames = torch.from_numpy(_frames(face, rng, 0)[0])
    frames = frames[None] if entry == "process_window" else frames
    msr = tms.MultiStreamRecognizer(tmodel, face, window=WIN)
    want, _ = getattr(msr, entry)(frames, msr.init_state(S, (H, W)))

    seen = []
    ops = msr._ops[msr.device]
    corr = ops.locator.corr

    def spy(windows):
        seen.append(tdevice.tf32_flags())
        return corr(windows)

    msr._ops[msr.device] = ops._replace(locator=ops.locator._replace(corr=spy))
    before = tdevice.tf32_flags()
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        assert tdevice.tf32_flags() == {"matmul_allow_tf32": True, "cudnn_allow_tf32": True}
        got, _ = getattr(msr, entry)(frames, msr.init_state(S, (H, W)))
        after = tdevice.tf32_flags()
        with pytest.raises(ZeroDivisionError), tdevice.exact_float32():
            1 / 0
        after_error = tdevice.tf32_flags()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before["matmul_allow_tf32"]
        torch.backends.cudnn.allow_tf32 = before["cudnn_allow_tf32"]
    assert seen == [{"matmul_allow_tf32": False, "cudnn_allow_tf32": False}]
    assert after == after_error == {"matmul_allow_tf32": True, "cudnn_allow_tf32": True}
    assert tdevice.tf32_flags() == before
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_bench_tracker_is_planted_exact_with_the_jax_keys(monkeypatch):
    """``bench.tracker`` at 2 streams of 480 x 640 and 3 batches on the CPU:
    both fps published (every plant found, gallery row 0), and the key set
    of the JAX ``bench_tracker`` at the same size (its size table patched
    alike; 1 window)."""
    monkeypatch.setitem(tbench.SIZES, "small", (480, 640))
    monkeypatch.setitem(jbench.SIZES, "small", (480, 640))
    got = tbench.tracker(streams=2, size="small", batches=3, loops=1, device=CPU)
    want = jbench.bench_tracker(streams=2, size="small", batches=3, loops=1)
    assert set(got) == set(want)
    assert got["tracker_planted_pos_exact"] and got["tracker_planted_id_exact"]
    assert got["tracker_window_planted_exact"]
    assert got["tracker_fps"] > 0 and got["tracker_window_fps"] > 0
    assert got["tracker_min_conf"] > 0.999 and got["tracker_windows"] == 1
    for key in ("tracker_streams", "tracker_batches", "tracker_size", "tracker_engine",
                "tracker_planted_pos_exact", "tracker_planted_id_exact",
                "tracker_window_planted_exact"):
        assert got[key] == want[key], key


def test_bench_tracker_zeroes_the_fps_when_a_plant_is_missed(monkeypatch):
    """One plant moved by a pixel after the frames were made: the first pass
    reports the real face, so the check fails and both fps are 0."""
    assets = tbench.tracker_assets

    def one_wrong(*args, **kwargs):
        frames, gallery_images, face, plants = assets(*args, **kwargs)
        plants = plants.copy()
        plants[1, 0, 1] += 1
        return frames, gallery_images, face, plants

    monkeypatch.setitem(tbench.SIZES, "small", (480, 640))
    monkeypatch.setattr(tbench, "tracker_assets", one_wrong)
    got = tbench.tracker(streams=2, size="small", batches=3, loops=1, device=CPU)
    assert not got["tracker_planted_pos_exact"] and got["tracker_planted_id_exact"]
    assert got["tracker_fps"] == got["tracker_window_fps"] == 0.0
    assert got["tracker_step_ms"] > 0


def test_bench_tracker_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.tracker(streams=2, size="544p", batches=1)
