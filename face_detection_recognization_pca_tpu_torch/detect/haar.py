"""Viola-Jones Haar cascade detector (port of ``detect/haar.py``).

The reference detects faces with
``cv2.CascadeClassifier('haarcascade_frontalface_default.xml')
.detectMultiScale(gray, 1.1, 5, minSize=(30, 30))``
(``detection-v4.py:18,50-55``).  :class:`HaarDetector` computes the same
thing on a torch device:

1. **Pyramid**: like modern OpenCV, the *image* is rescaled per level
   (factor ``1.1^i``) and the 24x24 cascade always runs at base size,
   windows on a stride-2 grid (stride 1 for levels with factor > 2).
2. **Dense stages**: per level, the first ``dense_stages`` stages are
   evaluated for every window of the grid.  The rect corners a stage
   reads are gathered through a strided view of the level's integral
   image (no index tensor), and one matmul against the stage's sparse
   corner-weight matrix turns them into every stump's rect sums.
3. **Compaction**: the passing windows of all levels and frames are
   listed by one ``torch.nonzero``; the remaining stages run on those
   candidates only, in groups, the survivors listed again after each
   group.  This is the cascade's early exit, breadth first: a window is
   accepted when it passes every stage.  Survivor counts are dynamic, so
   nothing is ever truncated and the result does not depend on
   ``dense_stages`` or on the grouping.

Precision of each step: the resize is float32 (``ops/resize``'s two
interpolation matmuls, always in full float32, never TF32); the result is
not rounded.  Integral and squared integral, the window norm, the rect
sums, the stump tests and the stage sums are float64: a float32 squared
integral is inexact after a few hundred pixels, and then the accept set
would depend on the order in which a device sums.

Window normalization follows OpenCV's current convention: inner
``(1, 1, 22, 22)`` norm rect, ``nf = sqrt(area * sqsum - sum^2)``
(1 when that is not positive), stump test ``rectsum < threshold * nf``.

Grouping reproduces ``groupRectangles(minNeighbors, eps=0.2)``:
union-find partition under the SimilarRects predicate, cluster
averaging, count thresholding, and the contained-in-bigger-cluster
rejection pass.  It runs on the host, per frame, through the native
library when that is built and in Python otherwise.  Tilted features are
not supported (the default frontal-face cascade has none).
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.device import exact_float32, resolve_device
from face_detection_recognization_pca_tpu_torch.ops.resize import resize_bilinear

# OpenCV's file, verbatim, as package data: where OpenCV is not installed.
PACKAGED_CASCADE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data",
    "haarcascade_frontalface_default.xml",
)
DEFAULT_CASCADE_PATHS = (
    "/usr/share/opencv4/haarcascades/haarcascade_frontalface_default.xml",
    "haarcascade_frontalface_default.xml",
    PACKAGED_CASCADE,
)

Box = Tuple[int, int, int, int]


@dataclasses.dataclass
class HaarCascade:
    """Parsed stump cascade in flat arrays."""

    window_size: Tuple[int, int]  # (h, w), typically (24, 24)
    stage_thresholds: np.ndarray  # (nstages,)
    stage_offsets: np.ndarray  # (nstages + 1,) stump index ranges
    stump_feature: np.ndarray  # (S,) feature index per stump
    stump_threshold: np.ndarray  # (S,)
    leaf0: np.ndarray  # (S,) value when rectsum <  t * nf
    leaf1: np.ndarray  # (S,) value when rectsum >= t * nf
    rects: np.ndarray  # (F, 3, 5) x, y, w, h, weight (0-weight padded)
    corner_matrix: np.ndarray  # (625, S) f32: patch -> rectsum matmul

    @property
    def n_stages(self) -> int:
        return len(self.stage_thresholds)

    @property
    def n_stumps(self) -> int:
        return len(self.stump_threshold)


def _parse_numbers(text: str) -> List[float]:
    return [float(t) for t in text.split()]


def find_cascade() -> str:
    """The first of :data:`DEFAULT_CASCADE_PATHS` that exists."""
    for p in DEFAULT_CASCADE_PATHS:
        if os.path.exists(p):
            return p
    raise FileNotFoundError("no haarcascade_frontalface_default.xml found; pass a path")


def load_cascade(path: Optional[str] = None) -> HaarCascade:
    """Parse an OpenCV new-format (cascade-classifier) stump XML."""
    if path is None:
        path = find_cascade()
    root = ET.parse(path).getroot()
    casc = root.find("cascade")
    if casc is None:
        raise ValueError(f"{path}: not a new-format cascade XML")
    if casc.findtext("featureType", "").strip() != "HAAR":
        raise ValueError("only HAAR featureType cascades are supported")
    height = int(casc.findtext("height"))
    width = int(casc.findtext("width"))

    stage_thresholds = []
    stage_offsets = [0]
    stump_feature, stump_threshold, leaf0, leaf1 = [], [], [], []
    for stage in casc.find("stages"):
        stage_thresholds.append(float(stage.findtext("stageThreshold")))
        weaks = stage.find("weakClassifiers")
        for weak in weaks:
            nodes = _parse_numbers(weak.findtext("internalNodes"))
            leaves = _parse_numbers(weak.findtext("leafValues"))
            if len(nodes) != 4 or len(leaves) != 2:
                raise ValueError("only stump cascades are supported")
            stump_feature.append(int(nodes[2]))
            stump_threshold.append(nodes[3])
            leaf0.append(leaves[0])
            leaf1.append(leaves[1])
        stage_offsets.append(len(stump_feature))

    feats = casc.find("features")
    rects = np.zeros((len(feats), 3, 5), dtype=np.float64)
    for fi, feat in enumerate(feats):
        tilted = feat.findtext("tilted")
        if tilted is not None and int(tilted.strip()) != 0:
            raise ValueError("tilted Haar features are not supported")
        for ri, r in enumerate(feat.find("rects")):
            vals = _parse_numbers(r.text)
            rects[fi, ri, :] = vals

    S = len(stump_feature)
    stump_feature = np.asarray(stump_feature, dtype=np.int32)
    # Corner matrix: patch (25 x 25 integral window, flattened 625) ->
    # rect sums for every stump.  Rect (x, y, w, h, wt) contributes
    # +wt at (y, x) & (y+h, x+w), -wt at (y, x+w) & (y+h, x).
    side = max(height, width) + 1
    corner = np.zeros((side * side, S), dtype=np.float32)
    for s in range(S):
        for (x, y, w, h, wt) in rects[stump_feature[s]]:
            if wt == 0.0:
                continue
            x, y, w, h = int(x), int(y), int(w), int(h)
            corner[y * side + x, s] += wt
            corner[(y + h) * side + (x + w), s] += wt
            corner[y * side + (x + w), s] -= wt
            corner[(y + h) * side + x, s] -= wt

    return HaarCascade(
        window_size=(height, width),
        stage_thresholds=np.asarray(stage_thresholds, dtype=np.float32),
        stage_offsets=np.asarray(stage_offsets, dtype=np.int32),
        stump_feature=stump_feature,
        stump_threshold=np.asarray(stump_threshold, dtype=np.float32),
        leaf0=np.asarray(leaf0, dtype=np.float32),
        leaf1=np.asarray(leaf1, dtype=np.float32),
        rects=rects,
        corner_matrix=corner,
    )


def _pyramid_levels(
    h: int,
    w: int,
    window: Tuple[int, int],
    scale_factor: float,
    min_size: Tuple[int, int],
    max_size: Optional[Tuple[int, int]],
) -> List[Tuple[float, int, int, int]]:
    """The level plan [(factor, sh, sw, step)] of an ``(h, w)`` frame."""
    wh, ww = window
    levels = []
    factor = 1.0
    while True:
        win_w = int(round(ww * factor))
        win_h = int(round(wh * factor))
        sw, sh = int(round(w / factor)), int(round(h / factor))
        if sw - ww <= 0 or sh - wh <= 0:
            break
        if max_size and (win_w > max_size[0] or win_h > max_size[1]):
            break
        if win_w >= min_size[0] and win_h >= min_size[1]:
            step = 1 if factor > 2.0 else 2
            levels.append((factor, sh, sw, step))
        factor *= scale_factor
    return levels


# ---------------------------------------------------------------------------
# The cascade on a device
# ---------------------------------------------------------------------------

# Stage boundaries at which the candidates are listed again.  Early stages
# reject most windows, so they are taken one or two at a time; the long
# tail runs on the few candidates left.  Any schedule gives the same result.
_COMPACT_AT = (1, 2, 3, 5, 8, 12)
# The most float64 values one gathered corner block may hold (1 GiB):
# larger blocks are evaluated in slices.
_MAX_BLOCK_VALUES = 1 << 27


@dataclasses.dataclass
class _StageGroup:
    """Stages ``lo..hi`` of the cascade as device tensors: the distinct
    integral corners their rects read, and the sparse matrix that turns
    those ``C`` corner values into the ``n`` stumps' rect sums."""

    cy: torch.Tensor  # (C,) int64 corner rows inside the 25 x 25 patch
    cx: torch.Tensor  # (C,) int64 corner columns
    weights: torch.Tensor  # (C, n) float64
    threshold: torch.Tensor  # (n,) float64
    leaf0: torch.Tensor  # (n,) float64
    leaf1: torch.Tensor  # (n,) float64
    stage_of: torch.Tensor  # (n, hi - lo) float64 one-hot stage membership
    stage_threshold: torch.Tensor  # (hi - lo,) float64


def _build_stage_group(cascade: HaarCascade, lo: int, hi: int, device: torch.device) -> _StageGroup:
    s0, s1 = int(cascade.stage_offsets[lo]), int(cascade.stage_offsets[hi])
    corner_index: Dict[Tuple[int, int], int] = {}
    entries = []  # (corner, stump, weight)
    for s in range(s0, s1):
        for (x, y, w, h, wt) in cascade.rects[cascade.stump_feature[s]]:
            if wt == 0.0:
                continue
            x, y, w, h = int(x), int(y), int(w), int(h)
            for cy, cx, sign in ((y, x, 1), (y + h, x + w, 1), (y, x + w, -1), (y + h, x, -1)):
                c = corner_index.setdefault((cy, cx), len(corner_index))
                entries.append((c, s - s0, sign * wt))
    weights = np.zeros((len(corner_index), s1 - s0), dtype=np.float64)
    for c, s, wt in entries:
        weights[c, s] += wt
    stage_of = np.zeros((s1 - s0, hi - lo), dtype=np.float64)
    for si in range(lo, hi):
        a, b = int(cascade.stage_offsets[si]), int(cascade.stage_offsets[si + 1])
        stage_of[a - s0 : b - s0, si - lo] = 1.0
    corners = np.array(list(corner_index), dtype=np.int64).reshape(-1, 2)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return _StageGroup(
        cy=dev(corners[:, 0]),
        cx=dev(corners[:, 1]),
        weights=dev(weights),
        threshold=dev(cascade.stump_threshold[s0:s1].astype(np.float64)),
        leaf0=dev(cascade.leaf0[s0:s1].astype(np.float64)),
        leaf1=dev(cascade.leaf1[s0:s1].astype(np.float64)),
        stage_of=dev(stage_of),
        stage_threshold=dev(cascade.stage_thresholds[lo:hi].astype(np.float64)),
    )


def _stages_pass(corners: torch.Tensor, nf: torch.Tensor, g: _StageGroup) -> torch.Tensor:
    """Windows' gathered corner values ``(..., C)`` and norms ``(...)`` ->
    bool ``(...)``: the window passes every stage of the group.  (With the
    windows as the fast axis instead, ``(C, ...)``, the card took 8% longer.)"""
    rect_sums = corners @ g.weights
    leaves = torch.where(rect_sums < g.threshold * nf.unsqueeze(-1), g.leaf0, g.leaf1)
    return (leaves @ g.stage_of >= g.stage_threshold).all(dim=-1)


class HaarDetector:
    """``detectMultiScale`` with reference parameter semantics, computing
    on ``device`` (``None``: the CUDA device).

    ``dense_stages`` is how many stages run over every window before the
    first compaction; it moves time between the two halves and never
    changes a detection."""

    def __init__(
        self,
        cascade: Optional[HaarCascade] = None,
        device: Optional[Union[str, torch.device]] = None,
        dense_stages: int = 3,
    ):
        self.cascade = cascade or load_cascade()
        self.device = resolve_device(device)
        self.dense_stages = max(1, min(int(dense_stages), self.cascade.n_stages))
        self._groups: Dict[Tuple[int, int], _StageGroup] = {}

    def _group(self, lo: int, hi: int) -> _StageGroup:
        key = (lo, hi)
        if key not in self._groups:
            self._groups[key] = _build_stage_group(self.cascade, lo, hi, self.device)
        return self._groups[key]

    def detect_multi_scale(
        self,
        gray,
        scale_factor: float = 1.1,
        min_neighbors: int = 5,
        min_size: Tuple[int, int] = (30, 30),
        max_size: Optional[Tuple[int, int]] = None,
    ) -> List[Box]:
        """Faces of one ``(H, W)`` gray frame as (x, y, w, h), grouped like
        the reference's call (detection-v4.py:50-55)."""
        return self.detect_multi_scale_batch(
            gray[None], scale_factor, min_neighbors, min_size, max_size
        )[0]

    def detect_multi_scale_batch(
        self,
        grays,
        scale_factor: float = 1.1,
        min_neighbors: int = 5,
        min_size: Tuple[int, int] = (30, 30),
        max_size: Optional[Tuple[int, int]] = None,
    ) -> List[List[Box]]:
        """Batched detectMultiScale of ``(B, H, W)`` frames (a numpy array
        or a tensor, on any device): one list of boxes per frame, each
        equal to the single-frame call's."""
        return self.detect_finish(
            self.detect_device(grays, scale_factor, min_neighbors, min_size, max_size)
        )

    def detect_device(
        self,
        grays,
        scale_factor: float = 1.1,
        min_neighbors: int = 5,
        min_size: Tuple[int, int] = (30, 30),
        max_size: Optional[Tuple[int, int]] = None,
    ) -> dict:
        """Device half of :meth:`detect_multi_scale_batch`: runs the
        cascade over every level of ``(B, H, W)`` frames of any dtype and
        starts the download of the accepted windows, without waiting for
        it.  A streaming caller issues the next batch's device half before
        calling :meth:`detect_finish` on this one, so the download and the
        host's grouping overlap the next batch's work.

        Returns a handle for :meth:`detect_finish`.  Besides what that
        needs it holds ``windows`` (per frame, over all levels) and
        ``survivors``, the ``(stages done, candidates left)`` after each
        compaction over the whole batch."""
        frames = torch.as_tensor(grays).to(self.device)
        nb, h, w = frames.shape
        wh, ww = self.cascade.window_size
        levels = _pyramid_levels(h, w, (wh, ww), scale_factor, min_size, max_size)
        handle = {
            "frames": nb,
            "levels": levels,
            "min_neighbors": min_neighbors,
            "windows": 0,
            "survivors": [],
            "rows": None,
            "ready": None,
        }
        if not levels or nb == 0:
            return handle
        with exact_float32():
            rows = self._accepted_windows(frames.to(torch.float32), levels, handle)
        if self.device.type == "cuda":
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            host.copy_(rows, non_blocking=True)
            handle["ready"] = torch.cuda.Event()
            handle["ready"].record()
        else:
            host = rows
        handle["rows"] = host
        return handle

    def _accepted_windows(self, frames: torch.Tensor, levels, handle: dict) -> torch.Tensor:
        """int32 ``(n, 4)`` rows ``(frame, level, y, x)`` of the windows
        that pass all stages, ``y`` and ``x`` in level coordinates, sorted
        by level, then frame, then ``y``, then ``x``."""
        dev = self.device
        nb, h, w = frames.shape
        wh, ww = self.cascade.window_size
        side = max(wh, ww) + 1
        grids = [((sh - wh) // st + 1, (sw - ww) // st + 1) for (_, sh, sw, st) in levels]
        # Every level's integral lies in one flat buffer, and its windows'
        # norms and dense-stage verdicts in two more, level after level, so
        # that one nonzero lists the candidates of the whole batch and one
        # gather reads any of them.
        int_sizes = [nb * (sh + 1) * (sw + 1) for (_, sh, sw, _) in levels]
        win_sizes = [nb * ny * nx for ny, nx in grids]
        int_starts = np.concatenate([[0], np.cumsum(int_sizes)]).astype(np.int64)
        win_starts = np.concatenate([[0], np.cumsum(win_sizes)]).astype(np.int64)
        integrals = torch.empty(int(int_starts[-1]), dtype=torch.float64, device=dev)
        norms = torch.empty(int(win_starts[-1]), dtype=torch.float64, device=dev)
        passed = torch.empty(int(win_starts[-1]), dtype=torch.bool, device=dev)
        handle["windows"] = int(win_starts[-1]) // nb
        area = float((wh - 2) * (ww - 2))
        dense = self._group(0, self.dense_stages)

        for li, (_, sh, sw, step) in enumerate(levels):
            ny, nx = grids[li]
            scaled = frames if (sh, sw) == (h, w) else resize_bilinear(frames, (sw, sh))
            f = scaled.to(torch.float64)
            h1, w1 = sh + 1, sw + 1
            ii = integrals[int_starts[li] : int_starts[li + 1]].view(nb, h1, w1)
            ii[:, 0, :] = 0.0
            ii[:, :, 0] = 0.0
            ii[:, 1:, 1:] = torch.cumsum(torch.cumsum(f, dim=1), dim=2)
            sq = torch.zeros((nb, h1, w1), dtype=torch.float64, device=dev)
            sq[:, 1:, 1:] = torch.cumsum(torch.cumsum(f * f, dim=1), dim=2)

            def grid_sum(t, y, x, rh, rw):
                def sl(dy, dx):
                    return t[
                        :,
                        y + dy : y + dy + (ny - 1) * step + 1 : step,
                        x + dx : x + dx + (nx - 1) * step + 1 : step,
                    ]

                return sl(rh, rw) - sl(rh, 0) - sl(0, rw) + sl(0, 0)

            s1 = grid_sum(ii, 1, 1, wh - 2, ww - 2)
            s2 = grid_sum(sq, 1, 1, wh - 2, ww - 2)
            nf2 = area * s2 - s1 * s1
            nf = torch.where(nf2 > 0, torch.sqrt(nf2.clamp_min(0.0)), 1.0)
            norms[win_starts[li] : win_starts[li + 1]].view(nb, ny, nx).copy_(nf)

            # Window (b, i, j)'s 25 x 25 integral patch, as a view.
            patches = ii.as_strided(
                (nb, ny, nx, side, side), (h1 * w1, step * w1, step, w1, 1)
            )
            ok = passed[win_starts[li] : win_starts[li + 1]].view(nb, ny, nx)
            per = max(1, _MAX_BLOCK_VALUES // (ny * nx * len(dense.cy)))
            for b0 in range(0, nb, per):
                corners = patches[b0 : b0 + per, :, :, dense.cy, dense.cx]
                ok[b0 : b0 + per] = _stages_pass(corners, nf[b0 : b0 + per], dense)

        # Compaction: the candidates of all levels, as indices into the
        # window buffers (sorted, so level, frame, y, x ascending).
        idx = torch.nonzero(passed).squeeze(1)
        t_win_starts = torch.from_numpy(win_starts).to(dev)
        t_int_starts = torch.from_numpy(int_starts[:-1].copy()).to(dev)
        t_ny = torch.tensor([g[0] for g in grids], dtype=torch.int64, device=dev)
        t_nx = torch.tensor([g[1] for g in grids], dtype=torch.int64, device=dev)
        t_step = torch.tensor([lv[3] for lv in levels], dtype=torch.int64, device=dev)
        t_h1 = torch.tensor([lv[1] + 1 for lv in levels], dtype=torch.int64, device=dev)
        t_w1 = torch.tensor([lv[2] + 1 for lv in levels], dtype=torch.int64, device=dev)
        level = torch.bucketize(idx, t_win_starts[1:], right=True)
        rest = idx - t_win_starts[level]
        per_frame = t_ny[level] * t_nx[level]
        frame = rest // per_frame
        rest = rest - frame * per_frame
        y = (rest // t_nx[level]) * t_step[level]
        x = (rest % t_nx[level]) * t_step[level]
        # Where each candidate's patch starts in the flat integral buffer,
        # and the row stride of its level's integral there.
        w1 = t_w1[level]
        base = t_int_starts[level] + (frame * t_h1[level] + y) * w1 + x
        nf = norms[idx]
        rows = torch.stack([frame, level, y, x], dim=1).to(torch.int32)
        handle["survivors"].append((self.dense_stages, int(idx.numel())))

        n_stages = self.cascade.n_stages
        bounds = sorted({self.dense_stages, n_stages}
                        | {s for s in _COMPACT_AT if self.dense_stages < s < n_stages})
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if rows.shape[0] == 0:
                break
            g = self._group(lo, hi)
            n = rows.shape[0]
            ok = torch.empty(n, dtype=torch.bool, device=dev)
            per = max(1, _MAX_BLOCK_VALUES // len(g.cy))
            for c0 in range(0, n, per):
                sel = slice(c0, c0 + per)
                corners = integrals[base[sel, None] + g.cy * w1[sel, None] + g.cx]
                ok[sel] = _stages_pass(corners, nf[sel], g)
            keep = torch.nonzero(ok).squeeze(1)
            rows, base, w1, nf = rows[keep], base[keep], w1[keep], nf[keep]
            handle["survivors"].append((hi, int(keep.numel())))
        return rows

    def detect_finish(self, handle: dict) -> List[List[Box]]:
        """Host half: wait for the download of ``handle``'s accepted
        windows, scale them to frame coordinates and group them per
        frame."""
        nb = handle["frames"]
        raw: List[List[Box]] = [[] for _ in range(nb)]
        if handle["rows"] is not None:
            if handle["ready"] is not None:
                handle["ready"].synchronize()
            rows = handle["rows"].numpy()
            wh, ww = self.cascade.window_size
            factors = np.array([lv[0] for lv in handle["levels"]], dtype=np.float64)
            f = factors[rows[:, 1]]
            # np.rint rounds half to even, as round() does.
            xs = np.rint(rows[:, 3].astype(np.float64) * f).astype(int)
            ys = np.rint(rows[:, 2].astype(np.float64) * f).astype(int)
            ws = np.rint(ww * f).astype(int)
            hs = np.rint(wh * f).astype(int)
            boxes = np.stack([xs, ys, ws, hs], axis=1)
            for b in range(nb):
                # Boolean selection keeps the rows' order: level, y, x.
                raw[b] = [tuple(r) for r in boxes[rows[:, 0] == b].tolist()]
        return [group_rectangles(r, handle["min_neighbors"], eps=0.2) for r in raw]


# ---------------------------------------------------------------------------
# groupRectangles
# ---------------------------------------------------------------------------


def group_rectangles(
    rects: Sequence[Box],
    group_threshold: int,
    eps: float = 0.2,
) -> List[Box]:
    """OpenCV ``groupRectangles`` semantics: union-find under the
    SimilarRects predicate, average each cluster, keep clusters with
    more than ``group_threshold`` members minus the contained-rect
    rejection pass.

    Dispatches to the native C++ implementation when built; the numpy
    form below is the fallback and the parity oracle."""
    n = len(rects)
    if n == 0:
        return []
    if group_threshold <= 0:
        return list(rects)
    from face_detection_recognization_pca_tpu_torch.io.native import group_rectangles_native

    native = group_rectangles_native(rects, group_threshold, eps)
    if native is not None:
        return native
    return _group_rectangles_py(rects, group_threshold, eps)


def _group_rectangles_py(
    rects: Sequence[Box],
    group_threshold: int,
    eps: float = 0.2,
) -> List[Box]:
    """numpy ``group_rectangles`` (fallback + native-parity oracle)."""
    n = len(rects)
    if n == 0:
        return []
    if group_threshold <= 0:
        return list(rects)
    # The SimilarRects predicate for every pair at once, then the
    # partition it spans: each rectangle takes the smallest index it can
    # reach, so clusters come out in the order of their first member and
    # hold their members in ascending order, as a union-find pass over
    # the pairs leaves them.
    arr = np.asarray(rects, dtype=np.float64)
    x, y, w, h = (arr[:, c] for c in range(4))
    delta = eps * 0.5 * (np.minimum(w[:, None], w[None, :]) + np.minimum(h[:, None], h[None, :]))
    similar = (
        (np.abs(x[:, None] - x[None, :]) <= delta)
        & (np.abs(y[:, None] - y[None, :]) <= delta)
        & (np.abs(x[:, None] + w[:, None] - x[None, :] - w[None, :]) <= delta)
        & (np.abs(y[:, None] + h[:, None] - y[None, :] - h[None, :]) <= delta)
    )
    np.fill_diagonal(similar, True)
    label = np.arange(n)
    while True:
        reach = np.where(similar, label[None, :], n).min(axis=1)
        if np.array_equal(reach, label):
            break
        label = reach
    clusters = {}
    for i in range(n):
        clusters.setdefault(int(label[i]), []).append(i)

    merged = []
    for members in clusters.values():
        cnt = len(members)
        if cnt <= group_threshold:
            continue
        m = arr[members].mean(axis=0)
        merged.append(
            (
                int(round(m[0])),
                int(round(m[1])),
                int(round(m[2])),
                int(round(m[3])),
                cnt,
            )
        )

    out = []
    for i, r1 in enumerate(merged):
        keep = True
        for j, r2 in enumerate(merged):
            if i == j:
                continue
            dx = int(round(r2[2] * eps))
            dy = int(round(r2[3] * eps))
            inside = (
                r1[0] >= r2[0] - dx
                and r1[1] >= r2[1] - dy
                and r1[0] + r1[2] <= r2[0] + r2[2] + dx
                and r1[1] + r1[3] <= r2[1] + r2[3] + dy
            )
            if inside and (r2[4] > max(3, r1[4]) or r1[4] < 3):
                keep = False
                break
        if keep:
            out.append((r1[0], r1[1], r1[2], r1[3]))
    return out
