"""The CPU side of the tracker's NCC kernel (``ops/ncc_locate.py``,
``csrc/ncc_locate.cu``): the route by shape, the template spectrum's
layout against ``np.fft.rfft2``, the plain route against the direct
TM_CCOEFF_NORMED, the wrapper's refusals, and the step's counters of the
route it took.  The kernel itself runs only on the card
(``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

from face_detection_recognization_pca_tpu_torch.ops import ncc_locate as nl
from face_detection_recognization_pca_tpu_torch.parallel import multistream as tms
from face_detection_recognization_pca_tpu_torch.utils import profiling

CPU = torch.device("cpu")
LANE = np.arange(32)
BREV = np.array([int(f"{v:05b}"[::-1], 2) for v in LANE])


@pytest.mark.parametrize("win, tpl, takes", [
    (192, 96, True),    # the cells, the headline, a tracked scan of a 96-px face
    (192, 86, True),    # 107 x 107 scores: the most the plane leaves room for
    (192, 85, False),   # 108 x 108
    (150, 96, True),    # zero-padded to the plane
    (128, 64, True),
    (128, 22, True),
    (128, 21, False),
    (130, 20, False),
    (60, 20, True),
    (96, 40, True),
    (1, 1, True),
    (193, 96, False),   # no window above the plane
    (256, 128, False),  # headline_geom256 keeps the plain route
    (96, 97, False),
    (96, 0, False),
])
def test_the_kernel_takes_a_shape_when_its_plane_and_statistics_fit(win, tpl, takes):
    assert nl.kernel_takes(win, tpl) is takes
    if takes:
        assert nl.smem_bytes(win - tpl + 1) <= nl.SMEM_LIMIT


def test_the_cells_block_takes_most_of_an_sm():
    assert nl.smem_bytes(97) == 36_864 + 148_992 + 37_636 + 96 == 223_588


def test_the_locator_takes_the_plain_route_on_the_cpu():
    """A shape the kernel takes still locates by the plain route on the CPU,
    with the centred template's energy, and gives the plain route's
    ``(ly, lx, tm_conf)``."""
    t0 = np.arange(16, dtype=np.float32).reshape(4, 4)
    t0 = t0 - t0.mean()
    assert nl.kernel_takes(8, 4)
    loc = nl.locator(t0, 8, CPU)
    assert loc.route == "plain" and isinstance(loc, nl.PlainLocator)
    assert loc.tpl == 4 and loc.t_energy.dtype == torch.float32 and loc.t_energy.dim() == 0
    assert float(loc.t_energy) == np.float32(np.sum(t0 * t0, dtype=np.float64))
    windows = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 8, 8)).astype(np.float32))
    mean = windows.mean()
    corr, band = nl.plain_operands(t0, 8, CPU)
    want = nl.ncc_locate_plain(windows, mean, corr, band, loc.t_energy, 4)
    assert all(torch.equal(a, b) for a, b in zip(loc(windows, mean), want))


def test_the_template_spectrum_is_laid_out_as_the_column_pass_reads_it():
    rng = np.random.default_rng(3)
    t0 = rng.normal(size=(96, 96))
    spec = nl.template_spectrum(t0)
    assert spec.shape == (97, 6, 32, 2) and spec.dtype == np.float32
    full = np.conj(np.fft.fft2(np.pad(t0, ((0, 96), (0, 96))))) / (2 * 192 ** 2)
    c, k1, lane = 37, 4, 5
    row = k1 + 6 * BREV[lane]
    assert spec[c, k1, lane, 0] == np.float32(full[row, c].real)
    assert spec[c, k1, lane, 1] == np.float32(full[row, c].imag)
    with pytest.raises(ValueError, match="does not fit"):
        nl.template_spectrum(rng.normal(size=(193, 193)))


@pytest.mark.parametrize("tpl", [96, 86, 64, 40, 20])
def test_every_entry_of_the_template_spectrum_is_the_rfft2_at_its_lane_order(tpl):
    """Column c, register k1, lane l hold the row frequency k1 + 6
    brev5(l) of ``conj(rfft2(t0 padded to 192)) / (2 192^2)``."""
    t0 = np.random.default_rng(tpl).normal(size=(tpl, tpl))
    spec = nl.template_spectrum(t0)
    kf = np.conj(np.fft.rfft2(t0, s=(192, 192))) / (2 * 192 ** 2)  # (192, 97)
    rows = np.arange(6)[:, None] + 6 * BREV[None, :]  # (6, 32)
    want = kf[rows].transpose(2, 0, 1)  # (97, 6, 32)
    np.testing.assert_array_equal(spec[..., 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(spec[..., 1], want.imag.astype(np.float32))
    assert sorted(rows.ravel()) == list(range(192))


def _direct_scores(w_c, t0):
    """TM_CCOEFF_NORMED in float64 by its definition, with the port's
    score-0 rule (``var_n <= n``)."""
    tpl, out = t0.shape[0], w_c.shape[0] - t0.shape[0] + 1
    n, t_energy = tpl * tpl, np.sum(t0 * t0)
    scores = np.zeros((out, out))
    for y in range(out):
        for x in range(out):
            patch = w_c[y:y + tpl, x:x + tpl]
            var_n = max(np.sum(patch * patch) - np.sum(patch) ** 2 / n, 0.0)
            if var_n > n:
                scores[y, x] = np.clip(np.sum(patch * t0) / np.sqrt(t_energy * var_n), -1, 1)
    return scores


@pytest.mark.parametrize("win, tpl", [(24, 8), (31, 12), (40, 40)])
def test_the_plain_route_gives_the_direct_scores_and_their_first_maximum(win, tpl):
    """The route the kernel is held to: ``plain_operands`` and
    ``ncc_locate_plain`` against the definition, a planted template found."""
    rng = np.random.default_rng(win + tpl)
    t = rng.uniform(0, 255, (tpl, tpl)).astype(np.float32)
    windows = (110 + 25 * rng.standard_normal((2, win, win))).astype(np.float32)
    places = rng.integers(0, win - tpl + 1, (2, 2))
    for i, (y, x) in enumerate(places):
        windows[i, y:y + tpl, x:x + tpl] = t + rng.normal(0, 4, (tpl, tpl))
    t0 = t - t.mean()
    corr, band = nl.plain_operands(t0, win, CPU)
    assert band.shape == (win, win - tpl + 1)
    mean = torch.tensor(windows.mean())
    t_energy = torch.tensor(np.float32(np.sum(t0.astype(np.float64) ** 2)))
    scores = nl.ncc_scores_plain(torch.from_numpy(windows), mean, corr, band, t_energy, tpl)
    ly, lx, conf = nl.ncc_locate_plain(torch.from_numpy(windows), mean, corr, band, t_energy, tpl)
    for i in range(2):
        want = _direct_scores(windows[i].astype(np.float64) - float(mean), t0.astype(np.float64))
        np.testing.assert_allclose(scores[i].numpy(), want, rtol=0, atol=2e-5)
        assert (int(ly[i]), int(lx[i])) == tuple(places[i])
        assert float(conf[i]) == float(scores[i].max())


# ---- the wrapper ---------------------------------------------------------------------------


def _args(s=2, win=192, tpl=96):
    spectrum = torch.from_numpy(nl.template_spectrum(np.zeros((tpl, tpl))))
    return [torch.zeros(s, win, win), torch.tensor(0.0), spectrum, torch.tensor(1.0), tpl]


def test_the_wrapper_refuses_the_cpu_and_points_at_the_plain_version():
    before = nl.ncc_locate.launches
    with pytest.raises(ValueError, match="ncc_locate_plain"):
        nl.ncc_locate(*_args())
    assert nl.ncc_locate.launches == before


@pytest.mark.parametrize("which, bad, error, match", [
    (0, torch.zeros(2, 192, 192, dtype=torch.float64), TypeError, "windows must be torch.float32"),
    (1, torch.tensor(0.0, dtype=torch.float64), TypeError, "mean must be torch.float32"),
    (3, [1.0], TypeError, "t_energy must be a tensor"),
    (0, torch.zeros(2, 192, 190), ValueError, r"\(S, win, win\)"),
    (0, torch.zeros(0, 192, 192), ValueError, "S >= 1"),
    (0, torch.zeros(2, 192, 384)[:, :, ::2], ValueError, "contiguous"),
    (1, torch.zeros(1), ValueError, "0-d"),
    (2, torch.zeros(97, 6, 32), ValueError, "spectrum must be"),
    (2, torch.zeros(96, 6, 32, 2), ValueError, "spectrum must be"),
    (0, torch.zeros(2, 193, 193), ValueError, "template in 193 windows"),
    (4, 193, ValueError, "193 template in 192"),
    (4, 80, ValueError, "shared memory"),
])
def test_the_wrapper_checks_its_arguments(which, bad, error, match):
    args = _args()
    args[which] = bad
    with pytest.raises(error, match=match):
        nl.ncc_locate(*args)


# ---- the step's route and counters ---------------------------------------------------------


def _tracker():
    from face_detection_recognization_pca_tpu_torch import bench
    from face_detection_recognization_pca_tpu_torch.models.eigenfaces import train_v1

    streams, (h, w), batches = 2, (480, 640), 2
    frames, gallery, face, plants = bench.tracker_assets(streams, (h, w), batches, 4, CPU)
    model, _ = train_v1(gallery, n_components=8)
    msr = tms.MultiStreamRecognizer(model, face, window=bench.WIN)
    boxes0 = np.stack([plants[0, :, 1], plants[0, :, 0], np.zeros(streams), np.zeros(streams)],
                      1).astype(np.int32)
    return msr, frames, msr.init_state(streams, (h, w), boxes0)


def _kernel_route(monkeypatch, plain: nl.PlainLocator, calls: list) -> nl.KernelLocator:
    """A kernel locator whose ``ncc_locate`` is the plain route (the kernel
    runs only on the card); ``calls`` gets each call's spectrum and whether
    its windows were contiguous."""
    def fake(windows, mean, spectrum, t_energy, tpl):
        calls.append((spectrum, windows.is_contiguous()))
        return plain(windows, mean)

    monkeypatch.setattr(nl, "ncc_locate", fake)
    return nl.KernelLocator(torch.zeros(1), plain.t_energy, plain.tpl)


def test_each_step_counts_the_route_it_took(monkeypatch):
    """The plain route on the CPU, once per step; a step whose locator takes
    the kernel's route goes to ``ncc_locate`` instead and counts
    ``multistream.ncc.kernel``."""
    msr, frames, state = _tracker()
    want, _ = msr.process_window(frames, state)
    ops = msr._ops[msr.device]
    calls = []

    profiling.enable(True)
    try:
        msr.process_window(frames, state)
        plain = profiling.snapshot()["counters"]
        profiling.reset()
        kernel = _kernel_route(monkeypatch, ops.locator, calls)
        msr._ops[msr.device] = ops._replace(locator=kernel)
        got, _ = msr.process_window(frames, state)
        by_kernel = profiling.snapshot()["counters"]
    finally:
        profiling.enable(False)
        profiling.reset()
    steps = frames.shape[0]
    assert plain == {"multistream.ncc.plain": steps}
    assert by_kernel == {"multistream.ncc.kernel": steps}
    assert len(calls) == steps and all(c[0] is kernel.spectrum for c in calls)
    assert all(torch.equal(want[k], got[k]) for k in want)


def test_the_kernel_route_hands_the_kernel_whole_windows_of_a_view(monkeypatch):
    """The headline's windows are a view of its frames; the kernel takes
    only contiguous windows, so the step hands it a contiguous copy and
    locates as the plain route does on the view."""
    msr, frames, state = _tracker()
    ops = msr._ops[msr.device]
    view = frames[:, :, 100:100 + ops.win, 200:200 + ops.win].reshape(-1, ops.win, ops.win)
    assert not view.is_contiguous()
    want = tms.locate_and_match(view, view.mean(), ops)
    calls = []
    kernel = _kernel_route(monkeypatch, ops.locator, calls)
    got = tms.locate_and_match(view, view.mean(), ops._replace(locator=kernel))
    assert [contiguous for _, contiguous in calls] == [True]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
