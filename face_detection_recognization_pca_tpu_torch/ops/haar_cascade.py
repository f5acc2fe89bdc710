"""The Haar cascade's stages in one launch per batch (``csrc/haar_cascade.cu``).

:class:`..detect.haar.HaarDetector` computes the level integrals and window
norms of a batch into two flat float64 buffers; on a CUDA device
:func:`haar_cascade` then runs every stage of the cascade over every
window of every level and frame in one kernel launch, which leaves each
window at its first failed stage and counts the windows past each
compaction boundary.  The plain version is the detector's own path on the
CPU (its dense stage group, the compaction and the later stage groups),
which the tests hold the kernel to; :func:`haar_cascade` itself takes CUDA
tensors only.

The kernel reads the cascade as :func:`pack_cascade` lays it out, once per
detector: per stump its rects' weights, threshold and leaves, and the
offsets of its rects' corners inside the kernel's shared-memory tile of
``TILE`` x ``TILE`` windows, for both window strides (1 and 2) of the
pyramid.  :func:`corner_offset` is that tile's layout: a stride-2 tile is
kept as four parity planes, so that neighbouring windows read neighbouring
values.  :func:`level_table` describes a batch's levels to the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.ops import _build

# csrc/haar_cascade.cu's kTile: windows per tile side; the launch refuses
# another value.
TILE = 16
STRIDES = (1, 2)


class PackedCascade(NamedTuple):
    """A stump cascade as the kernel reads it, on one device."""

    # (S, 8) float32: weights of rects 0-2, threshold, leaf0, leaf1, rect count (int32 bits), 0
    common: torch.Tensor
    # (2, S, 12) int32: per stride, each rect's corners a, b, c, d in the tile
    offsets: torch.Tensor
    # (n_stages, 4) int32: first stump, end stump, threshold (float32 bits), 0
    stages: torch.Tensor
    # (G,) int32: the stage after which each compaction falls; the last is n_stages
    bounds: torch.Tensor
    window: Tuple[int, int]  # (h, w)


class LevelTable(NamedTuple):
    """A batch's levels for the kernel: per level (a column of ``table``)
    the start of its integral and its windows in the flat buffers, its
    integral's frame stride, ``ny``, ``nx``, stride, integral row length
    and first tile (the rows, in that order)."""

    table: torch.Tensor  # (8, L) int64, on the device
    integral_size: int  # float64 values of every level's integral
    windows: int  # windows of every level and frame
    tiles: int


def plane_shape(step: int, window: Tuple[int, int]) -> Tuple[int, int]:
    """Rows and columns of one parity plane of a tile at ``step``: the tile
    holds ``(TILE - 1) * step + window + 1`` integral rows and columns."""
    return tuple(-(-((TILE - 1) * step + side + 1) // step) for side in window)


def corner_offset(y, x, step: int, window: Tuple[int, int]):
    """Where integral element ``(y, x)`` of a tile (relative to its first
    window's corner) lies in the kernel's shared memory: plane ``(y % step,
    x % step)``, row ``y // step``, column ``x // step``.  Window ``(i, j)``
    of the tile reads corner ``(y, x)`` at ``i * cols + j`` past this."""
    rows, cols = plane_shape(step, window)
    return ((y % step) * step + x % step) * rows * cols + (y // step) * cols + x // step


def pack_cascade(cascade, bounds: Sequence[int], device: torch.device) -> PackedCascade:
    """The kernel's tables of ``cascade`` (a ``detect.haar.HaarCascade``)
    and the compaction ``bounds`` on ``device``.  Raises ``ValueError`` for
    a cascade the kernel does not take: a stump without rects or with more
    than 3, a rect outside the window, or a weight that float32 does not
    hold exactly."""
    wh, ww = cascade.window_size
    n = cascade.n_stumps
    bounds = [int(b) for b in bounds]
    if (not bounds or bounds != sorted(set(bounds)) or bounds[0] < 1
            or bounds[-1] != cascade.n_stages):
        raise ValueError(f"bounds {bounds} must rise from 1 to the {cascade.n_stages} stages")
    rects = cascade.rects[cascade.stump_feature]  # (S, 3, 5)
    common = np.zeros((n, 8), dtype=np.float32)
    offsets = np.zeros((2, n, 12), dtype=np.int32)
    for s in range(n):
        used = [r for r in rects[s] if r[4] != 0.0]
        if not 1 <= len(used) <= 3:
            raise ValueError(f"stump {s} has {len(used)} rects; the kernel takes 1 to 3")
        for ri, (x, y, w, h, wt) in enumerate(used):
            x, y, w, h = int(x), int(y), int(w), int(h)
            if min(x, y, w, h) < 0 or x + w > ww or y + h > wh:
                raise ValueError(f"stump {s}: rect {(x, y, w, h)} outside the {ww} x {wh} window")
            if float(np.float32(wt)) != wt:
                raise ValueError(f"stump {s}: weight {wt} is not a float32 value")
            common[s, ri] = wt
            for si, step in enumerate(STRIDES):
                offsets[si, s, 4 * ri:4 * ri + 4] = [
                    corner_offset(cy, cx, step, (wh, ww))
                    for cy, cx in ((y, x), (y, x + w), (y + h, x), (y + h, x + w))]
        common[s, 6:7].view(np.int32)[0] = len(used)
    common[:, 3] = cascade.stump_threshold
    common[:, 4] = cascade.leaf0
    common[:, 5] = cascade.leaf1
    stages = np.zeros((cascade.n_stages, 4), dtype=np.int32)
    stages[:, 0] = cascade.stage_offsets[:-1]
    stages[:, 1] = cascade.stage_offsets[1:]
    stages[:, 2] = np.asarray(cascade.stage_thresholds, dtype=np.float32).view(np.int32)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PackedCascade(dev(common), dev(offsets), dev(stages),
                         dev(np.asarray(bounds, dtype=np.int32)), (wh, ww))


def level_table(nb: int, levels, grids, int_starts, win_starts, window: Tuple[int, int],
                device: torch.device) -> LevelTable:
    """The kernel's table of ``nb`` frames' ``levels`` (``(factor, sh, sw,
    step)``), their window ``grids`` (``(ny, nx)``) and the flat buffers'
    level starts ``int_starts`` and ``win_starts`` (each with the total
    last), checked against each other; copied to ``device`` without
    waiting for it."""
    wh, ww = window
    rows: List[List[int]] = []
    tiles = 0
    for li, ((_, sh, sw, step), (ny, nx)) in enumerate(zip(levels, grids)):
        h1, w1 = sh + 1, sw + 1
        if step not in STRIDES:
            raise ValueError(f"level {li}: stride {step}; the kernel takes 1 or 2")
        if ny < 1 or nx < 1 or (ny - 1) * step + wh > sh or (nx - 1) * step + ww > sw:
            raise ValueError(f"level {li}: a {ny} x {nx} grid at stride {step} leaves the "
                             f"{sh} x {sw} level")
        if (int_starts[li + 1] - int_starts[li] != nb * h1 * w1
                or win_starts[li + 1] - win_starts[li] != nb * ny * nx):
            raise ValueError(f"level {li}: the buffer starts do not match {nb} frames of it")
        rows.append([int(int_starts[li]), int(win_starts[li]), h1 * w1, ny, nx, step, w1, tiles])
        tiles += nb * -(-ny // TILE) * -(-nx // TILE)
    table = torch.tensor(rows, dtype=torch.int64).reshape(-1, 8).T.contiguous()
    if device.type == "cuda":
        table = table.pin_memory()
    return LevelTable(table.to(device, non_blocking=True), int(int_starts[len(rows)]),
                      int(win_starts[len(rows)]), tiles)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a library built from
    ``csrc/haar_cascade.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.haar_cascade_launch.argtypes = [ptr, ptr, ptr, i32, ctypes.c_longlong, ptr, ptr, i32, ptr,
                                        i32, ptr, i32, i32, i32, i32, ptr, ptr, ptr]
    lib.haar_cascade_launch.restype = i32
    lib.haar_cascade_error_string.argtypes = [i32]
    lib.haar_cascade_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _declare(_build.load("haar_cascade"))


def _check_args(integrals, norms, levels: LevelTable, packed: PackedCascade):
    named = {"integrals": (integrals, torch.float64), "norms": (norms, torch.float64),
             "levels.table": (levels.table, torch.int64), "common": (packed.common, torch.float32),
             "offsets": (packed.offsets, torch.int32), "stages": (packed.stages, torch.int32),
             "bounds": (packed.bounds, torch.int32)}
    for name, (t, dtype) in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != integrals.device:
            raise ValueError(f"{name} is on {t.device}, integrals on {integrals.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = packed.common.shape[0]
    shapes = {"integrals": (levels.integral_size,), "norms": (levels.windows,),
              "levels.table": (8, levels.table.shape[1]), "common": (n, 8),
              "offsets": (2, n, 12), "stages": (packed.stages.shape[0], 4),
              "bounds": (packed.bounds.shape[0],)}
    for name, shape in shapes.items():
        if tuple(named[name][0].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name][0].shape)}, expected {shape}")
    if levels.tiles < 1 or n < 1 or packed.bounds.numel() < 1:
        raise ValueError("no windows, stumps or boundaries")


def haar_cascade(integrals: torch.Tensor, norms: torch.Tensor, levels: LevelTable,
                 packed: PackedCascade) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(passed, counts)``: bool ``(W,)``, whether each window of the flat
    window buffer passes every stage of ``packed``, and int64 ``(G,)``,
    the windows past each of ``packed.bounds``.

    ``integrals`` and ``norms`` are the flat float64 buffers that
    ``levels`` describes; everything lies on one CUDA device.  Launches
    ``csrc/haar_cascade.cu`` once on the current stream (building it at
    first use) and raises if the build or the launch fails;
    ``haar_cascade.launches`` counts the launches."""
    _check_args(integrals, norms, levels, packed)
    device = integrals.device
    if device.type != "cuda":
        raise ValueError(f"haar_cascade runs on CUDA tensors, got {device}; the plain version "
                         "is HaarDetector's path on the CPU")
    lib = _lib()
    g = packed.bounds.numel()
    wh, ww = packed.window
    with torch.cuda.device(device):
        passed = torch.empty(levels.windows, dtype=torch.bool, device=device)
        counts = torch.empty(g + 1, dtype=torch.int64, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.haar_cascade_launch(
            integrals.data_ptr(), norms.data_ptr(), levels.table.data_ptr(),
            levels.table.shape[1], levels.tiles, packed.common.data_ptr(),
            packed.offsets.data_ptr(), packed.common.shape[0], packed.stages.data_ptr(),
            packed.stages.shape[0], packed.bounds.data_ptr(), g, wh, ww, TILE,
            passed.data_ptr(), counts.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"haar_cascade launch failed: {lib.haar_cascade_error_string(err).decode()}")
    haar_cascade.launches += 1
    return passed, counts[:g]


haar_cascade.launches = 0
