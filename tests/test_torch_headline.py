"""Port parity for the headline bench at a small size: the fixed-window
scan against the JAX package's ``_make_bench_scan`` on the same numpy
frames and operands, the assets against ``_synth_assets`` for one seed,
the closed-form FLOP count, and the self-check that zeroes the fps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu import bench as jbench
from face_detection_recognization_pca_tpu.ops import dft_match as jdft
from face_detection_recognization_pca_tpu_torch import bench as tbench
from face_detection_recognization_pca_tpu_torch import device as tdevice
from face_detection_recognization_pca_tpu_torch.ops import fused_match as tfm
from face_detection_recognization_pca_tpu_torch.parallel import multistream as tms

torch.set_num_threads(1)

CPU = torch.device("cpu")
T, S, SIZE, WIN, TPL, K, N, SEED = 2, 3, (160, 200), 64, 32, 8, 16, 3
# Float32 sums in other orders (the global mean, the DFT matmuls, the
# projection); the scores are cosines and NCC values <= 1.
CONF_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_assets():
    frames, origin, lin, face = jbench._synth_assets(S, SIZE, gallery_n=N, k=K, seed=SEED,
                                                     win=WIN, tpl=TPL)
    return np.asarray(frames), origin, lin, np.asarray(face), jbench._synth_assets.last_offs


@pytest.fixture(scope="module")
def port_assets():
    return tbench.headline_assets(S, SIZE, CPU, gallery_n=N, k=K, seed=SEED, win=WIN, tpl=TPL)


def test_headline_assets_match_jax(jax_assets, port_assets):
    jframes, jorigin, jlin, jface, joffs = jax_assets
    frames, origin, model, face, offs = port_assets
    assert origin == tuple(jorigin) == ((SIZE[0] - WIN) // 2, (SIZE[1] - WIN) // 2)
    np.testing.assert_array_equal(face, jface)
    np.testing.assert_array_equal(offs, joffs)
    assert offs.shape == (32 * S, 2) and offs.dtype == np.int32
    assert frames.shape == jframes.shape == (32, S, *SIZE) and frames.dtype == torch.float32
    # Every frame holds the face where the offsets say, in both packages.
    flat = frames.reshape(-1, *SIZE).numpy()
    for i in (0, 1, 50, 32 * S - 1):
        y, x = origin[0] + offs[i, 0], origin[1] + offs[i, 1]
        np.testing.assert_array_equal(flat[i, y:y + TPL, x:x + TPL], face)
        np.testing.assert_array_equal(jframes.reshape(-1, *SIZE)[i, y:y + TPL, x:x + TPL], face)
    # The noise is the port's own (a torch.Generator), with the JAX moments.
    noise = frames[..., :40, :]
    assert abs(float(noise.mean()) - 110) < 0.5 and abs(float(noise.std()) - 25) < 0.5

    # The model: the same training images in the same order of draws, so
    # the same linearized operands up to float32 eigenvectors (their signs
    # are arbitrary per component; 1e-3 of the operand's scale).
    assert model.n_components == K and model.gallery.shape == (N, K)
    assert model.face_shape == (TPL, TPL) and model.schema == "v1"
    lin = tfm.linearize_model(model, (TPL, TPL))
    jm, jbias, jgt = (np.asarray(a) for a in (jlin.m, jlin.bias, jlin.gallery_t))
    signs = np.sign(np.sum(lin.m.numpy() * jm, axis=0))
    np.testing.assert_allclose(lin.m.numpy() * signs, jm, rtol=0, atol=1e-3 * np.abs(jm).max())
    np.testing.assert_allclose(lin.bias.numpy() * signs, jbias, rtol=0,
                               atol=1e-3 * np.abs(jbias).max())
    np.testing.assert_allclose(lin.gallery_t.numpy() * signs[:, None], jgt, rtol=0,
                               atol=1e-3 * np.abs(jgt).max())
    np.testing.assert_allclose(lin.gallery_norm.numpy(), np.asarray(jlin.gallery_norm),
                               rtol=1e-4)
    np.testing.assert_array_equal(lin.labels.numpy(), np.asarray(jlin.labels))


def _jax_scan(frames, lin, face, origin):
    template0 = face - float(face.mean())
    t_energy = jnp.asarray(np.sum(template0 * template0, dtype=np.float64).astype(np.float32))
    scan = jbench._make_bench_scan(
        jdft.make_circular_correlator(template0, WIN, WIN - TPL + 1), win=WIN, tpl=TPL)
    out = scan(jnp.asarray(frames), t_energy, lin.m, lin.bias, lin.gallery_t, lin.gallery_norm,
               win_y=origin[0], win_x=origin[1])
    return [np.asarray(a) for a in out]


def test_headline_scan_matches_jax_on_the_same_frames(jax_assets):
    """The JAX package's frames (its own noise) and its linearized model,
    carried over as numpy arrays, through both scans."""
    jframes, origin, jlin, face, offs = jax_assets
    frames = jframes[:T]
    ids_j, conf_j, tm_j, x_j, y_j = _jax_scan(frames, jlin, face, origin)
    lin = tfm.LinearizedModel(
        *(torch.from_numpy(np.array(a)) for a in (jlin.m, jlin.bias, jlin.gallery_t,
                                                  jlin.gallery_norm, jlin.labels)),
        (TPL, TPL))
    ops = tms.step_operands(lin, face, WIN, CPU)
    launches = tfm.fused_match.launches
    ids, conf, tm, x, y = tbench.headline_scan(torch.from_numpy(frames), ops, *origin)
    assert tfm.fused_match.launches == launches  # CPU tensors take the plain path
    assert ids.shape == (T * S,) and ids.dtype == x.dtype == y.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    np.testing.assert_array_equal(x.numpy(), x_j)
    np.testing.assert_array_equal(y.numpy(), y_j)
    np.testing.assert_allclose(conf.numpy(), conf_j, rtol=0, atol=CONF_ATOL)
    np.testing.assert_allclose(tm.numpy(), tm_j, rtol=0, atol=CONF_ATOL)
    # Both found what was planted.
    np.testing.assert_array_equal(x.numpy(), origin[1] + offs[:T * S, 1])
    np.testing.assert_array_equal(y.numpy(), origin[0] + offs[:T * S, 0])
    assert (ids == 0).all() and float(conf.min()) > 0.999 and float(tm.min()) > 0.99
    assert tbench.headline_self_check((ids, conf, tm, x, y), offs[:T * S], *origin) == (1.0, 1.0)


def test_headline_scan_is_the_trackers_step_with_a_fixed_origin(port_assets):
    """One frame batch through ``MultiStreamRecognizer.process_batch`` from
    the fixed origin gives the same bits as the headline scan of it."""
    frames, origin, model, face, _ = port_assets
    ops = tms.step_operands(tfm.linearize_model(model, (TPL, TPL)), face, WIN, CPU)
    ids, conf, tm, x, y = tbench.headline_scan(frames[:1], ops, *origin)
    msr = tms.MultiStreamRecognizer(model, face, window=WIN)
    boxes = np.tile([origin[1] + (WIN - TPL) // 2, origin[0] + (WIN - TPL) // 2, 0, 0], (S, 1))
    out, _ = msr.process_batch(frames[0], msr.init_state(S, SIZE, boxes))
    for key, got in (("gallery_row", ids), ("confidence", conf), ("template_confidence", tm),
                     ("x", x), ("y", y)):
        assert torch.equal(out[key], got), key


@pytest.mark.parametrize("kwargs", [{}, {"k": 8, "gallery_n": 16}, {"win": 256, "tpl": 128},
                                    {"k": 100, "gallery_n": 969, "win": 64, "tpl": 32}])
def test_headline_flops_per_frame_equals_jax(kwargs):
    assert tbench.headline_flops_per_frame(**kwargs) == jbench.headline_flops_per_frame(**kwargs)
    assert (tbench.WIN, tbench.TPL) == (jbench.WIN, jbench.TPL)


def _small_headline(**kwargs):
    return tbench.headline(streams=S, size=SIZE, iters=1, warmup=0, win=WIN, tpl=TPL,
                           t_frames=T, device=CPU, **kwargs)


def test_headline_publishes_only_a_checked_fps(monkeypatch):
    result = _small_headline(with_train=False)
    detail = result["detail"]
    assert result["value"] > 0 and detail["self_check"] == "ok"
    assert detail["planted_offset_exact"] == detail["planted_id_rate"] == 1.0
    assert detail["frames_per_dispatch"] == T * S and detail["streams"] == S
    assert detail["step_ms"] > 0 and detail["pca_train_wall_s_969x4096_k100"] == 0.0
    assert detail["headline_mflops_per_frame"] == pytest.approx(
        jbench.headline_flops_per_frame(win=WIN, tpl=TPL) / 1e6)
    # A CPU run says so, counts no launch and names no device metric.
    assert detail["device"] == "cpu" and result["unit"] == "frames/s on the CPU"
    assert detail["fused_match_launches"] == 0
    assert "vs_baseline" not in result and not any("pct" in key for key in detail)

    # One planted offset off by a pixel: the fps is zeroed.
    assets = tbench.headline_assets

    def one_wrong(*args, **kwargs):
        frames, origin, model, face, offs = assets(*args, **kwargs)
        offs = offs.copy()
        offs[T * S - 1, 1] += 1
        return frames, origin, model, face, offs

    monkeypatch.setattr(tbench, "headline_assets", one_wrong)
    result = _small_headline(with_train=False)
    assert result["value"] == 0.0 and result["detail"]["self_check"] == "FAILED (fps zeroed)"
    assert result["detail"]["planted_offset_exact"] == pytest.approx(1 - 1 / (T * S))
    assert result["detail"]["planted_id_rate"] == 1.0


def test_headline_computes_in_full_float32_and_restores_the_flags():
    """Under ``set_float32_matmul_precision("high")`` the headline turns
    both TF32 switches off for its matmuls and puts them back."""
    seen = []
    scan = tbench.locate_and_match

    def spy(*args):
        seen.append(tdevice.tf32_flags())
        return scan(*args)

    before = tdevice.tf32_flags()
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        tbench.locate_and_match = spy
        result = _small_headline(with_train=False)
        after = tdevice.tf32_flags()
    finally:
        tbench.locate_and_match = scan
        torch.backends.cuda.matmul.allow_tf32 = before["matmul_allow_tf32"]
        torch.backends.cudnn.allow_tf32 = before["cudnn_allow_tf32"]
    assert result["detail"]["self_check"] == "ok"
    assert seen and not any(flag for flags in seen for flag in flags.values())
    assert after == {"matmul_allow_tf32": True, "cudnn_allow_tf32": True}


def test_headline_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.headline(streams=1, size=SIZE, win=WIN, tpl=TPL, t_frames=1)


def test_headline_times_one_window_and_reports_only_its_keys(monkeypatch):
    """One timed window of ``iters`` dispatches after the warm-up gives
    ``step_ms``; the detail holds the headline's keys and no profiled
    window, kernel time or share of a peak."""
    dispatches = []
    scan = tbench.headline_scan

    def counted(*args):
        dispatches.append(1)
        return scan(*args)

    monkeypatch.setattr(tbench, "headline_scan", counted)
    result = tbench.headline(streams=S, size=SIZE, iters=2, warmup=1, win=WIN, tpl=TPL,
                             t_frames=T, with_train=False, device=CPU)
    detail = result["detail"]
    assert len(dispatches) == 1 + 1 + 2
    assert detail["step_ms"] > 0
    assert result["value"] == pytest.approx(T * S / (detail["step_ms"] / 1e3))
    assert set(detail) == {
        "streams", "frames_per_dispatch", "step_ms", "fused_match_launches",
        "headline_mflops_per_frame", "min_pca_conf", "min_tm_conf", "planted_offset_exact",
        "planted_id_rate", "self_check", "pca_train_wall_s_969x4096_k100", "device"}


G256_SIZE = (300, 320)  # the smallest frames that hold a 256 x 256 window, rounded up


def test_headline_geom256_is_planted_exact_at_a_small_size():
    """Window 256, template 128, 2 streams x 1 frame batch of 300 x 320: the
    self-check holds and the fps is published."""
    got = tbench.headline_geom256(streams=2, iters=1, size=G256_SIZE, t_frames=1, device=CPU)
    assert got["g256_self_check"] == "ok" and got["g256_fps"] > 0
    assert got["g256_mflops_per_frame"] == pytest.approx(
        jbench.headline_flops_per_frame(win=256, tpl=128) / 1e6)
    assert set(got) == {"g256_fps", "g256_step_ms", "g256_mflops_per_frame", "g256_self_check"}


def test_headline_geom256_maps_the_headline_as_jax_does(monkeypatch):
    """Both packages' ``geom256`` over the same headline dict (one port run
    at a small size, handed to each through its headline function): equal
    outputs; and the port asks its headline for window 256, template 128,
    no training."""
    result = tbench.headline(streams=2, size=G256_SIZE, iters=1, warmup=0, win=256, tpl=128,
                             t_frames=1, with_train=False, device=CPU)
    calls = []

    def port_headline(**kwargs):
        calls.append(kwargs)
        return result

    monkeypatch.setattr(tbench, "headline", port_headline)
    monkeypatch.setattr(jbench, "bench_headline", lambda **kwargs: result)
    got = tbench.headline_geom256(streams=5, iters=7, device=CPU)
    want = jbench.bench_headline_geom256(streams=5, iters=7)
    assert got == {key: want[key] for key in got}
    assert got["g256_step_ms"] == result["detail"]["step_ms"] and got["g256_self_check"] == "ok"
    assert calls[0]["win"] == 256 and calls[0]["tpl"] == 128 and not calls[0]["with_train"]
    assert calls[0]["streams"] == 5 and calls[0]["iters"] == 7


def test_headline_geom256_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.headline_geom256(streams=1, size=G256_SIZE, t_frames=1)
