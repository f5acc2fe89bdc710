"""The tracker's TM_CCOEFF_NORMED locate in one launch per step (``csrc/ncc_locate.cu``).

For each of a step's ``(S, win, win)`` windows of raw pixels, centred on the
step's 0-d mean: the template's normalised correlation at every valid
offset and its first maximum, ``(ly, lx, tm_conf)``.  :func:`ncc_locate`
launches the kernel on CUDA tensors; :func:`ncc_locate_plain` is the same
function in plain PyTorch (the DFT-matmul numerator of
:func:`..ops.dft_match.make_circular_correlator` and banded-matmul box
sums), which the CPU and every window the kernel does not take run.

The kernel computes in one block per window: a real 2-D FFT of the window
zero-padded to :data:`PLANE` x :data:`PLANE`, the product with the
template's conjugate spectrum (:func:`template_spectrum`, made once per
template), the inverse pruned to the valid corner, the float64 box sums,
the scores and the argmax, with the plane and the statistics in shared
memory (:func:`smem_bytes`).  :func:`kernel_takes` says whether a window
and template fit it.

:func:`locator` chooses the route once per template, window side and
device, and holds that route's operands: the tracker's step calls the
locator it returns and knows neither route's operands.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Tuple, Union

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.ops import _build
from face_detection_recognization_pca_tpu_torch.ops.dft_match import make_circular_correlator

LANES = 32
# The kernel's plane side, 32 lanes of 6 points: every window is zero-padded to it.
PLANE = 192
# csrc/ncc_locate.cu's kWarps and kRows: the block's warps, and the box sums' rows per pass.
WARPS = 12
ROWS = 12
# Shared memory a block may take on sm_90 (227 KB), which the kernel is built for.
SMEM_LIMIT = 232_448


def smem_bytes(out: int) -> int:
    """Shared memory of one block for ``out`` x ``out`` scores: the box
    sums' float64 scratch, the half-spectrum plane, ``var_n`` and the warps'
    best scores (``ncc_locate_smem_bytes``)."""
    return 8 * 2 * ROWS * PLANE + 4 * PLANE * (PLANE + 2) + 4 * out * out + 8 * WARPS


def kernel_takes(win: int, tpl: int) -> bool:
    """Whether the kernel takes ``win`` x ``win`` windows and a ``tpl``
    template: a window of at most :data:`PLANE` whose ``win - tpl + 1``
    squared scores fit a block's shared memory beside the plane (at most
    107 x 107)."""
    return 1 <= tpl <= win <= PLANE and smem_bytes(win - tpl + 1) <= SMEM_LIMIT


def _brev5(lane: np.ndarray) -> np.ndarray:
    return np.array([int(f"{int(v):05b}"[::-1], 2) for v in lane])


def template_spectrum(t0: np.ndarray) -> np.ndarray:
    """The kernel's template operand: ``conj(fft2(t0 padded to m x m)) / (2
    m^2)``, m = :data:`PLANE`, in float64, cast to float32, for the ``m/2 +
    1`` columns of the half spectrum, as ``(m/2 + 1, m/32, 32, 2)``
    (column, register, lane, real/imaginary): row frequency ``k1 + (m/32) *
    brev5(lane)``, the order in which a column's transform leaves the
    points in a warp.  The 2 is the kernel's unhalved split of row pairs,
    the m^2 its unnormalised inverse."""
    th, tw = t0.shape
    if th > PLANE or tw > PLANE:
        raise ValueError(f"a {th} x {tw} template does not fit a plane of {PLANE}")
    m, r = PLANE, PLANE // LANES
    kpad = np.zeros((m, m), np.float64)
    kpad[:th, :tw] = np.asarray(t0, np.float64)
    kf = np.conj(np.fft.rfft2(kpad)) / (2.0 * m * m)  # (m, m/2 + 1)
    rows = np.arange(r)[:, None] + r * _brev5(np.arange(LANES))[None, :]  # (r, 32)
    ordered = kf[rows].transpose(2, 0, 1)  # (m/2 + 1, r, 32)
    return np.ascontiguousarray(np.stack([ordered.real, ordered.imag], -1).astype(np.float32))


def plain_operands(t0: np.ndarray, win: int,
                   device: torch.device) -> Tuple[Callable[[torch.Tensor], torch.Tensor],
                                                  torch.Tensor]:
    """The plain route's operands for the centred square template ``t0`` in
    ``win`` x ``win`` windows on ``device``: its valid correlator
    (:func:`..ops.dft_match.make_circular_correlator`) and the ``(win,
    out)`` banded ones of the box sums."""
    tpl = int(t0.shape[0])
    out_n = win - tpl + 1
    jj = np.arange(win)[:, None]
    xx = np.arange(out_n)[None, :]
    band = ((jj >= xx) & (jj < xx + tpl)).astype(np.float32)
    return make_circular_correlator(t0, win, out_n, device), torch.from_numpy(band).to(device)


def ncc_scores_plain(windows: torch.Tensor, mean: torch.Tensor, corr, band: torch.Tensor,
                     t_energy: torch.Tensor, tpl: int) -> torch.Tensor:
    """The ``(S, out, out)`` TM_CCOEFF_NORMED scores in plain PyTorch:
    ``corr`` is the centred template's valid correlator at the window's
    size (:func:`..ops.dft_match.make_circular_correlator`), ``band`` the
    (win, out) banded ones of the box sums."""
    windows_c = windows - mean
    num = corr(windows_c)
    s1 = band.T @ windows_c @ band
    s2 = band.T @ (windows_c * windows_c) @ band
    n = tpl * tpl
    var_n = torch.clamp(s2 - s1 * s1 / n, min=0.0)
    denom = torch.sqrt(t_energy * var_n)
    safe = var_n > n * 1.0
    return torch.clamp(
        torch.where(safe, num / torch.where(safe, denom, torch.ones_like(denom)), 0.0),
        -1.0, 1.0,
    )


def ncc_locate_plain(windows: torch.Tensor, mean: torch.Tensor, corr, band: torch.Tensor,
                     t_energy: torch.Tensor, tpl: int):
    """:func:`ncc_locate` in plain PyTorch: the first maximum of
    :func:`ncc_scores_plain`."""
    s, win = windows.shape[:2]
    out_n = win - tpl + 1
    flat = ncc_scores_plain(windows, mean, corr, band, t_energy, tpl).reshape(s, -1)
    loc = torch.argmax(flat, dim=1)  # first maximum
    tm_conf = torch.gather(flat, 1, loc[:, None])[:, 0]
    loc = loc.to(torch.int32)
    ly = torch.div(loc, out_n, rounding_mode="floor")
    return ly, loc - ly * out_n, tm_conf


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a library built from
    ``csrc/ncc_locate.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ncc_locate_launch.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.ncc_locate_launch.restype = i32
    lib.ncc_locate_smem_bytes.argtypes = [i32]
    lib.ncc_locate_smem_bytes.restype = ctypes.c_longlong
    lib.ncc_locate_error_string.argtypes = [i32]
    lib.ncc_locate_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _declare(_build.load("ncc_locate"))


def _check_args(windows, mean, spectrum, t_energy, tpl: int) -> None:
    """Raises on arguments the kernel does not take."""
    named = {"windows": windows, "mean": mean, "spectrum": spectrum, "t_energy": t_energy}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if t.device != windows.device:
            raise ValueError(f"{name} is on {t.device}, windows on {windows.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mean.dim() != 0 or t_energy.dim() != 0:
        raise ValueError("mean and t_energy must be 0-d")
    if windows.dim() != 3 or windows.shape[1] != windows.shape[2] or windows.shape[0] < 1:
        raise ValueError(f"windows must be (S, win, win) with S >= 1, got {tuple(windows.shape)}")
    win = windows.shape[1]
    want = (PLANE // 2 + 1, PLANE // LANES, LANES, 2)
    if tuple(spectrum.shape) != want:
        raise ValueError(f"spectrum must be {want} (template_spectrum), got "
                         f"{tuple(spectrum.shape)}")
    if not 1 <= tpl <= win <= PLANE:
        raise ValueError(f"a {tpl} template in {win} windows on a plane of {PLANE}")
    if smem_bytes(win - tpl + 1) > SMEM_LIMIT:
        raise ValueError(f"{win - tpl + 1}^2 scores exceed a block's shared memory beside the "
                         "plane; kernel_takes says which shapes fit")


def ncc_locate(windows: torch.Tensor, mean: torch.Tensor, spectrum: torch.Tensor,
               t_energy: torch.Tensor, tpl: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ly, lx, tm_conf)``: int32, int32 and float32 ``(S,)``, each
    window's first best TM_CCOEFF_NORMED offset and its score, as
    :func:`ncc_locate_plain` gives them.

    ``windows`` ``(S, win, win)`` float32 raw pixels; ``mean`` and
    ``t_energy`` (the centred template's energy) 0-d float32;
    ``spectrum`` from :func:`template_spectrum`; all contiguous on one CUDA
    device.  Launches ``csrc/ncc_locate.cu`` once on the current stream
    (building it at first use) and raises if the build or the launch fails;
    ``ncc_locate.launches`` counts the launches."""
    _check_args(windows, mean, spectrum, t_energy, tpl)
    device = windows.device
    if device.type != "cuda":
        raise ValueError(f"ncc_locate runs on CUDA tensors, got {device}; the plain version "
                         "is ncc_locate_plain")
    lib = _lib()
    s, win = windows.shape[:2]
    with torch.cuda.device(device):
        out = torch.empty((3, s), dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ncc_locate_launch(
            windows.data_ptr(), s, win, tpl, mean.data_ptr(), spectrum.data_ptr(),
            t_energy.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"ncc_locate launch failed: {lib.ncc_locate_error_string(err).decode()}")
    ncc_locate.launches += 1
    return out[0], out[1], out[2].view(torch.float32)


ncc_locate.launches = 0


class KernelLocator(NamedTuple):
    """The kernel's route: :func:`ncc_locate` with the template's spectrum."""

    spectrum: torch.Tensor  # template_spectrum
    t_energy: torch.Tensor  # () float32, the centred template's energy
    tpl: int
    route = "kernel"

    def __call__(self, windows: torch.Tensor, mean: torch.Tensor):
        # The kernel reads whole windows; the headline hands it a view of its frames.
        return ncc_locate(windows.contiguous(), mean, self.spectrum, self.t_energy, self.tpl)


class PlainLocator(NamedTuple):
    """The plain route: :func:`ncc_locate_plain` with :func:`plain_operands`."""

    corr: Callable[[torch.Tensor], torch.Tensor]  # the valid correlator
    band: torch.Tensor  # (win, out) banded ones
    t_energy: torch.Tensor
    tpl: int
    route = "plain"

    def __call__(self, windows: torch.Tensor, mean: torch.Tensor):
        return ncc_locate_plain(windows, mean, self.corr, self.band, self.t_energy, self.tpl)


Locator = Union[KernelLocator, PlainLocator]


def locator(t0: np.ndarray, win: int, device: torch.device) -> Locator:
    """The locate of the centred square template ``t0`` (float32) in ``win``
    x ``win`` windows on ``device``: called on ``(S, win, win)`` windows and
    the step's 0-d mean, it returns ``(ly, lx, tm_conf)`` as
    :func:`ncc_locate` does.  On a CUDA device where :func:`kernel_takes`
    the shape, the kernel's route (``route`` ``"kernel"``); otherwise the
    plain route (``"plain"``), as on the CPU."""
    device = torch.device(device)
    t0 = np.asarray(t0, np.float32)
    tpl = int(t0.shape[0])
    t_energy = torch.tensor(np.sum(t0 * t0, dtype=np.float64).astype(np.float32), device=device)
    if device.type == "cuda" and kernel_takes(win, tpl):
        return KernelLocator(torch.from_numpy(template_spectrum(t0)).to(device), t_energy, tpl)
    return PlainLocator(*plain_operands(t0, win, device), t_energy, tpl)
