"""Full-frame multi-template TM_CCOEFF detection (port of
``detect/ccoeff.py``, the reference's template-matching-as-detector
generation, ``useless/scan-template.py``).

Reference semantics (``useless/scan-template.py:59-166``): load at most
10 templates per ``faces/`` subdirectory, resize the *frame* by each
scale in {0.5, 0.7, 1.0, 1.3, 1.6} (``cv2.resize(gray, None, fx=scale,
fy=scale)``), run plain (unnormalized) TM_CCOEFF per template, take every
location whose raw score clears ``threshold``, map boxes back to
original coordinates (``x/scale``, template size ``/scale``), and prune
with ``cv2.dnn.NMSBoxes``-style greedy IoU NMS.  The surviving boxes feed
the v1 dual-PCA recognizer (:func:`..pipeline.v1_apps.scan_dual`).

Per frame on the device: one upload of the uint8 gray frame; per scale
the ``fx`` form of the exact resize
(:func:`..ops.resize.resize_bilinear_u8_exact_scale`); per shape group
of templates an ``rfft2`` of the level padded to 5-smooth sizes, the
product with the zero-meaned templates' conjugate spectra (kept per
group and padded size), ``irfft2``, and the top ``max_candidates + 1``
over every (template, position) with the largest |score|, so that a
caller can read the gap at rank ``max_candidates``.  Every (scale, group)
result comes back in one download.  The threshold, the box arithmetic (Python ints and
doubles, as in the JAX package) and the NMS run on the host.

Raw CCOEFF is an unnormalized sum over the template's pixels, so the 0.7
threshold passes about every position whose window correlates
positively with a template: the top-k decides which positions survive
(greedy NMS consumes candidates best-first, so the top-K set decides as
the reference's full candidate list does whenever fewer than K
candidates survive NMS).  The kept set is ordered by descending score,
ties by ascending flat index, as ``jax.lax.top_k`` orders it.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.device import resolve_device
from face_detection_recognization_pca_tpu_torch.io.images import imread_gray
from face_detection_recognization_pca_tpu_torch.ops.match import _next_fast_len
from face_detection_recognization_pca_tpu_torch.ops.nms import nms_boxes_cv2
from face_detection_recognization_pca_tpu_torch.ops.resize import (
    resize_bilinear_u8_exact_scale,
)

DEFAULT_SCALES = (0.5, 0.7, 1.0, 1.3, 1.6)

Box = Tuple[int, int, int, int]
# (scale, (th, tw), (level h, level w), scores, flat indices into (T, oh, ow),
#  largest |score|)
Candidates = Tuple[float, Tuple[int, int], Tuple[int, int], np.ndarray, np.ndarray, float]


def _ordered_topk(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of ``flat`` ordered by (-value, index)."""
    vals, idx = torch.topk(flat, min(k, flat.numel()))
    idx, order = torch.sort(idx)
    vals, order = torch.sort(vals[order], descending=True, stable=True)
    return vals, idx[order]


def _ccoeff_topk(
    frame: torch.Tensor, t0: torch.Tensor, k: int, kf: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k raw CCOEFF scores of all templates against one frame.

    frame ``(H, W)`` float32, t0 ``(T, th, tw)`` zero-meaned templates,
    ``kf`` their conjugate spectrum at the padded size -> (scores ``(k,)``
    descending, flat indices ``(k,)`` into ``(T, oh, ow)``, the largest
    |score|).  One frame rFFT is shared by every template of the group."""
    h, w = frame.shape
    th, tw = t0.shape[1], t0.shape[2]
    oh, ow = h - th + 1, w - tw + 1
    size = (_next_fast_len(h), _next_fast_len(w))
    ff = torch.fft.rfft2(frame, s=size)
    maps = torch.fft.irfft2(ff[None] * kf, s=size)[:, :oh, :ow]
    vals, idx = _ordered_topk(maps.reshape(-1), k)
    return vals, idx, torch.maximum(vals[0], -maps.amin())


class CcoeffTemplateDetector:
    """Reference template-matching detector, fused per (scale, group),
    computing on ``device`` (``None``: the CUDA device).

    Exposes :meth:`detect` and a Haar-protocol adapter
    :meth:`detect_multi_scale`, so it drops into
    :func:`..pipeline.v1_apps.scan_dual` as the detection engine."""

    def __init__(
        self,
        templates: Sequence[np.ndarray],
        scales: Sequence[float] = DEFAULT_SCALES,
        threshold: float = 0.7,
        nms_threshold: float = 0.3,
        max_candidates: int = 128,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.scales = tuple(scales)
        self.threshold = float(threshold)
        self.nms_threshold = float(nms_threshold)
        self.max_candidates = int(max_candidates)
        self.device = resolve_device(device)
        # Templates grouped by shape, each group one batched product; the
        # zero-meaning is numpy float32, as in the JAX package.
        groups: Dict[tuple, list] = {}
        for t in templates:
            t = np.asarray(t, dtype=np.float32)
            groups.setdefault(t.shape, []).append(t - t.mean())
        self.groups = [
            (shape, torch.from_numpy(np.stack(ts)).to(self.device))
            for shape, ts in groups.items()
        ]
        self._spectra: Dict[tuple, torch.Tensor] = {}

    @staticmethod
    def from_faces_dir(
        faces_dir: str,
        per_dir: int = 10,
        scales: Sequence[float] = DEFAULT_SCALES,
        threshold: float = 0.7,
        nms_threshold: float = 0.3,
        max_candidates: int = 128,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "CcoeffTemplateDetector":
        """Reference loading rule (``useless/scan-template.py:59-99``):
        first ``per_dir`` (default 10) ``*.jpg`` files of every
        subdirectory of ``faces_dir``, grayscale."""
        templates = []
        for sub in sorted(os.listdir(faces_dir)):
            sdir = os.path.join(faces_dir, sub)
            if not os.path.isdir(sdir):
                continue
            for p in sorted(glob.glob(os.path.join(sdir, "*.jpg")))[:per_dir]:
                img = imread_gray(p)
                if img is not None:
                    templates.append(img)
        if not templates:
            raise ValueError(f"no templates under {faces_dir}")
        return CcoeffTemplateDetector(
            templates, scales, threshold, nms_threshold, max_candidates, device
        )

    @property
    def n_templates(self) -> int:
        return sum(int(t0.shape[0]) for _, t0 in self.groups)

    def _spectrum(self, gi: int, size: Tuple[int, int]) -> torch.Tensor:
        key = (gi, size)
        if key not in self._spectra:
            self._spectra[key] = torch.conj(torch.fft.rfft2(self.groups[gi][1], s=size))
        return self._spectra[key]

    def levels(self, gray_frame) -> List[Tuple[float, torch.Tensor]]:
        """``(scale, uint8 level)`` per scale of one ``(H, W)`` gray frame
        (a host array or a tensor), on the device: the frame itself at
        scale 1, else ``cv2.resize(gray, None, fx=scale, fy=scale)``."""
        if not isinstance(gray_frame, torch.Tensor):
            gray_frame = torch.from_numpy(np.ascontiguousarray(gray_frame, dtype=np.uint8))
        frame = gray_frame.to(self.device)
        return [
            (s, frame if s == 1.0 else resize_bilinear_u8_exact_scale(frame, s, s))
            for s in self.scales
        ]

    def topk(self, gray_frame) -> List[Candidates]:
        """The device half of :meth:`detect` on one ``(H, W)`` uint8 gray
        frame: per (scale, group) that fits, ``(scale, (th, tw), (sh, sw),
        scores, flat indices, largest |score|)`` of the top
        ``max_candidates + 1`` (host arrays, all brought back in one
        download); :meth:`select` keeps ``max_candidates`` of them."""
        parts, vals, idx, peaks = [], [], [], []
        for scale, level in self.levels(gray_frame):
            sh, sw = level.shape
            size = (_next_fast_len(sh), _next_fast_len(sw))
            frame = level.to(torch.float32)
            for gi, ((th, tw), t0) in enumerate(self.groups):
                if th > sh or tw > sw:
                    continue
                v, i, peak = _ccoeff_topk(frame, t0, self.max_candidates + 1,
                                          self._spectrum(gi, size))
                parts.append((scale, (th, tw), (sh, sw), v.numel()))
                vals.append(v)
                idx.append(i)
                peaks.append(peak[None])
        if not parts:
            return []
        vals_h = torch.cat(vals + peaks).cpu().numpy()
        idx_h = torch.cat(idx).cpu().numpy()
        peaks_h = vals_h[len(vals_h) - len(peaks):]
        out, at = [], 0
        for (scale, tshape, lshape, n), peak in zip(parts, peaks_h):
            out.append((scale, tshape, lshape, vals_h[at : at + n], idx_h[at : at + n],
                        float(peak)))
            at += n
        return out

    def select(self, candidates: Sequence[Candidates]) -> List[Box]:
        """The host half of :meth:`detect`: the top ``max_candidates`` of
        each part, the threshold, the boxes in original coordinates (Python
        ints and doubles) and the NMS."""
        cands: List[Tuple[float, int, int, int, int]] = []
        for scale, (th, tw), (sh, sw), vals, idx, _ in candidates:
            ow = sw - tw + 1
            oh = sh - th + 1
            vals, idx = vals[: self.max_candidates], idx[: self.max_candidates]
            keep = vals >= self.threshold
            pos = idx[keep] % (oh * ow)
            for v, p in zip(vals[keep], pos):
                x = int((p % ow) / scale)
                y = int((p // ow) / scale)
                cands.append((float(v), x, y, int(tw / scale), int(th / scale)))
        if not cands:
            return []
        boxes = np.array([[x, y, w, h] for _, x, y, w, h in cands], dtype=np.float64)
        scores = np.array([c[0] for c in cands])
        # cv2.dnn.NMSBoxes semantics (useless/scan-template.py:156): the
        # reference passes its candidate threshold again as NMSBoxes'
        # score_threshold, whose strict > filter re-drops candidates at
        # exactly the threshold.
        keep = nms_boxes_cv2(
            torch.from_numpy(boxes), torch.from_numpy(scores), self.threshold, self.nms_threshold
        ).numpy()
        return [
            (int(x), int(y), int(w), int(h))
            for (_, x, y, w, h), k in zip(cands, keep)
            if k
        ]

    def detect(self, gray_frame) -> List[Box]:
        """Detected boxes ``[(x, y, w, h)]`` in original coordinates of one
        ``(H, W)`` uint8 gray frame."""
        return self.select(self.topk(gray_frame))

    # Haar detector protocol (scale_factor/min_neighbors/min_size are
    # Haar knobs; ignored here) so scan_dual can consume this engine.
    def detect_multi_scale(self, gray, *_args, **_kwargs) -> List[Box]:
        return self.detect(gray)
