"""OpenCV's ``detectMultiScale`` and ``groupRectangles`` from their
definitions, for stump cascades in OpenCV's XML format.

Per pyramid level (factor ``scale_factor**i``, the window 24 x 24 at base
size, the image resized to ``round(size / factor)``): every window on a
grid of step 2 (1 above factor 2) is normalised by the standard deviation
of its inner ``(1, 1, 22, 22)`` rectangle and passes stage after stage
while the sum of its stumps' leaves reaches the stage's threshold; a stump
takes its left leaf when its weighted rectangle sum is below its threshold
times the window's norm.  The windows that pass every stage are grouped
per frame.  The level images are a bilinear resize of the gray frame as
floats (the configuration's stated resize); integrals, norms and sums are
float64 (float32 in the control).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .eigenfaces import resize
from .numerics import Arith

Box = Tuple[int, int, int, int]


class Cascade(NamedTuple):
    size: Tuple[int, int]  # (h, w)
    stage_threshold: np.ndarray  # (stages,)
    stages: List[np.ndarray]  # per stage the indices of its stumps
    feature: np.ndarray  # (stumps,) feature index
    threshold: np.ndarray  # (stumps,)
    left: np.ndarray  # (stumps,) leaf when below
    right: np.ndarray  # (stumps,)
    rects: np.ndarray  # (features, 3, 5) x, y, w, h, weight; unused rects weigh 0


def load(path: str) -> Cascade:
    cascade = ET.parse(path).getroot().find("cascade")
    stage_threshold, stages, feature, threshold, left, right = [], [], [], [], [], []
    for stage in cascade.find("stages"):
        stage_threshold.append(float(stage.findtext("stageThreshold")))
        first = len(feature)
        for weak in stage.find("weakClassifiers"):
            nodes = weak.findtext("internalNodes").split()
            leaves = weak.findtext("leafValues").split()
            feature.append(int(nodes[2]))
            threshold.append(float(nodes[3]))
            left.append(float(leaves[0]))
            right.append(float(leaves[1]))
        stages.append(np.arange(first, len(feature)))
    feats = cascade.find("features")
    rects = np.zeros((len(feats), 3, 5))
    for i, feat in enumerate(feats):
        for j, rect in enumerate(feat.find("rects")):
            rects[i, j] = [float(v) for v in rect.text.split()]
    return Cascade((int(cascade.findtext("height")), int(cascade.findtext("width"))),
                   np.array(stage_threshold), stages, np.array(feature), np.array(threshold),
                   np.array(left), np.array(right), rects)


def gray_u8(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(bgr, COLOR_BGR2GRAY)`` of uint8: BT.601 weights in
    15-bit fixed point, rounded half up."""
    x = bgr.astype(np.int64)
    return ((3735 * x[..., 0] + 19235 * x[..., 1] + 9798 * x[..., 2] + (1 << 14)) >> 15).astype(np.uint8)


def levels(h: int, w: int, window: Tuple[int, int], scale_factor: float,
           min_size: Tuple[int, int]) -> List[Tuple[float, int, int, int]]:
    """``[(factor, sh, sw, step)]``: the image shrinks by ``factor`` until
    the window no longer fits; levels whose window at frame scale is under
    ``min_size`` are skipped."""
    out, factor = [], 1.0
    while True:
        win_h, win_w = int(np.rint(window[0] * factor)), int(np.rint(window[1] * factor))
        if win_h > h or win_w > w:
            return out
        sh, sw = int(np.rint(h / factor)), int(np.rint(w / factor))
        if win_w >= min_size[0] and win_h >= min_size[1] and sh >= window[0] and sw >= window[1]:
            out.append((factor, sh, sw, 1 if factor > 2.0 else 2))
        factor *= scale_factor


def _stage_offsets(cascade: Cascade, stumps: np.ndarray, w1: int):
    """Per stump-rect corner of ``stumps``: flat offsets into an integral of
    row length ``w1`` and signed weights, ``(n, 3, 4)`` each."""
    r = cascade.rects[cascade.feature[stumps]]  # (n, 3, 5)
    x, y, w, h, wt = (r[..., i] for i in range(5))
    dy = np.stack([y, y, y + h, y + h], -1)
    dx = np.stack([x, x + w, x, x + w], -1)
    sign = np.array([1.0, -1.0, -1.0, 1.0])
    return (dy * w1 + dx).astype(np.int64), wt[..., None] * sign


def _accepted(img: torch.Tensor, cascade: Cascade, step: int, ar: Arith,
              values_per_block: int = 1 << 25) -> torch.Tensor:
    """``(n, 3)`` (frame, y, x) of the windows of ``img`` (B, sh, sw) that
    pass every stage."""
    b, sh, sw = img.shape
    wh, ww = cascade.size
    dev = img.device
    f = img.to(ar.double)
    ii = torch.zeros((b, sh + 1, sw + 1), dtype=ar.double, device=dev)
    sq = torch.zeros_like(ii)
    ii[:, 1:, 1:] = f.cumsum(1).cumsum(2)
    sq[:, 1:, 1:] = (f * f).cumsum(1).cumsum(2)
    ys = torch.arange(0, sh - wh + 1, step, device=dev)
    xs = torch.arange(0, sw - ww + 1, step, device=dev)
    fb, fy, fx = torch.meshgrid(torch.arange(b, device=dev), ys, xs, indexing="ij")
    w1 = sw + 1
    base = (fb * (sh + 1) * w1 + fy * w1 + fx).reshape(-1)
    iif, sqf = ii.reshape(-1), sq.reshape(-1)

    def inner(t, at):
        corner = lambda dy, dx: t[at + dy * w1 + dx]  # noqa: E731
        return corner(1, 1) - corner(1, ww - 1) - corner(wh - 1, 1) + corner(wh - 1, ww - 1)

    area = (wh - 2) * (ww - 2)
    v = area * inner(sqf, base) - inner(iif, base) ** 2
    norm = torch.where(v > 0, torch.sqrt(torch.clamp(v, min=0)), torch.ones_like(v))
    alive = torch.arange(base.numel(), device=dev)
    for s, stumps in enumerate(cascade.stages):
        offs, weights = _stage_offsets(cascade, stumps, w1)
        offs = torch.from_numpy(offs).to(dev)
        weights = torch.from_numpy(weights).to(dev, ar.double)
        thr = torch.from_numpy(cascade.threshold[stumps]).to(dev, ar.double)
        lo = torch.from_numpy(cascade.left[stumps]).to(dev, ar.double)
        hi = torch.from_numpy(cascade.right[stumps]).to(dev, ar.double)
        keep = []
        block = max(1, values_per_block // offs.numel())
        for c0 in range(0, alive.numel(), block):
            cand = alive[c0:c0 + block]
            values = iif[base[cand, None, None, None] + offs]  # (c, n, 3, 4)
            feat = (values * weights).sum(dim=(2, 3))
            leaves = torch.where(feat < thr * norm[cand, None], lo, hi)
            keep.append(cand[leaves.sum(dim=1) >= float(cascade.stage_threshold[s])])
        alive = torch.cat(keep)
        if alive.numel() == 0:
            break
    per = ys.numel() * xs.numel()
    return torch.stack([alive // per, ys[(alive % per) // xs.numel()], xs[alive % xs.numel()]], 1)


def similar(a: np.ndarray, b: np.ndarray, eps: float) -> np.ndarray:
    """OpenCV's ``SimilarRects`` of every pair of rows of ``a`` and ``b``."""
    delta = eps * 0.5 * (np.minimum(a[:, None, 2], b[None, :, 2]) + np.minimum(a[:, None, 3], b[None, :, 3]))
    return ((np.abs(a[:, None, 0] - b[None, :, 0]) <= delta)
            & (np.abs(a[:, None, 1] - b[None, :, 1]) <= delta)
            & (np.abs(a[:, None, 0] + a[:, None, 2] - b[None, :, 0] - b[None, :, 2]) <= delta)
            & (np.abs(a[:, None, 1] + a[:, None, 3] - b[None, :, 1] - b[None, :, 3]) <= delta))


def group_rectangles(rects: Sequence[Box], threshold: int, eps: float = 0.2) -> List[Box]:
    """OpenCV's ``groupRectangles``: classes of the transitive closure of
    ``SimilarRects``, each averaged (rounded half to even), those with more
    than ``threshold`` members kept, less those inside a larger kept class
    that outnumbers them."""
    if not len(rects):
        return []
    r = np.asarray(rects, dtype=np.float64)
    parent = list(range(len(r)))

    def root(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i, j in zip(*np.nonzero(np.triu(similar(r, r, eps), 1))):
        parent[root(int(i))] = root(int(j))
    classes = {}
    for i in range(len(r)):
        classes.setdefault(root(i), []).append(i)
    kept = [(np.rint(r[m].mean(axis=0)).astype(int), len(m)) for m in classes.values()
            if len(m) > threshold]
    out = []
    for i, (r1, n1) in enumerate(kept):
        inside = False
        for j, (r2, n2) in enumerate(kept):
            if i == j:
                continue
            dx, dy = int(np.rint(r2[2] * eps)), int(np.rint(r2[3] * eps))
            if (r1[0] >= r2[0] - dx and r1[1] >= r2[1] - dy
                    and r1[0] + r1[2] <= r2[0] + r2[2] + dx and r1[1] + r1[3] <= r2[1] + r2[3] + dy
                    and (n2 > max(3, n1) or n1 < 3)):
                inside = True
                break
        if not inside:
            out.append(tuple(int(v) for v in r1))
    return out


def detect(grays: torch.Tensor, cascade: Cascade, ar: Arith, scale_factor: float = 1.1,
           min_neighbors: int = 5, min_size: Tuple[int, int] = (30, 30)) -> List[List[Box]]:
    """Faces of each ``(B, H, W)`` gray frame as (x, y, w, h)."""
    b, h, w = grays.shape
    raw: List[list] = [[] for _ in range(b)]
    frames = grays.to(ar.single)
    for factor, sh, sw, step in levels(h, w, cascade.size, scale_factor, min_size):
        img = frames if (sh, sw) == (h, w) else resize(frames, (sh, sw), ar)
        hits = _accepted(img, cascade, step, ar).cpu().numpy()
        side = int(np.rint(cascade.size[1] * factor)), int(np.rint(cascade.size[0] * factor))
        for frame, y, x in hits:
            raw[frame].append((int(np.rint(x * factor)), int(np.rint(y * factor)), *side))
    return [group_rectangles(r, min_neighbors) for r in raw]
