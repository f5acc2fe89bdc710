"""Shipped-output-video oracle: score our dual-model scan against the
reference's own annotated result videos (port of ``pipeline/oracle.py``).

The reference ships four annotated outputs (``output/recognized_*.mp4``,
writer ``useless/scan.py:530-539``) -- the only ground-truth record of
its per-frame decisions.  The drawing spec (``useless/scan.py:270-330``)
is fully recoverable by color masking:

* every drawn detection is a RED (BGR 0,0,255) SQUARE outline of side
  ``max(w, h)`` centered on the Haar box, thickness 2;
* a recognized face additionally gets a CYAN (255,255,0) FILLED label
  background directly above the box; unknown faces get a red filled one.

This module extracts those marks per frame (hollow red components ->
boxes; cyan label-shaped components adjacent above a box -> recognized),
re-runs the same dual-model scan with our framework (Haar detection +
exact float64 v1 recognition, ``useless/scan.py:58-166`` semantics), and
reports recognized-frame-set agreement + per-frame box IoU.

Caveats verified against the shipped artifacts (see tests):

* ``recognized_dual_mayun``'s footage itself contains cyan (a caption
  band), so the recognized-set metric is only sound for test/test2;
  mayun is anchored on box agreement.
* EVERY shipped run predates the 200 px annotation size filter in
  today's ``useless/scan.py:286``: mayun draws ~70 px boxes, test2
  ~65 px from frame 18, and test.mp4 frame 146 draws "Unknown (0.72)"
  on a 62 px wall-decal false positive (our detector scores the same
  spot 0.720).  Callers pass ``min_annotation_box=0`` to match.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Box = Tuple[int, int, int, int]


@dataclass
class FrameAnnotation:
    """Marks recovered (or produced) for one frame."""

    boxes: List[Box] = field(default_factory=list)
    recognized: bool = False


# ---------------------------------------------------------------------------
# Reference-video annotation extraction (color masking)
# ---------------------------------------------------------------------------


def _red_cyan_masks(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """H.264-tolerant masks for the drawing colors (pure BGR red/cyan
    survive 4:2:0 chroma subsampling as r>150,g,b<90 / b,g>150,r<110;
    calibrated on the shipped outputs)."""
    b = frame[:, :, 0].astype(np.int16)
    g = frame[:, :, 1].astype(np.int16)
    r = frame[:, :, 2].astype(np.int16)
    red = (r > 150) & (g < 90) & (b < 90)
    cyan = (b > 150) & (g > 150) & (r < 110)
    return red.astype(np.uint8), cyan.astype(np.uint8)


def extract_frame_annotations(
    frame: np.ndarray, min_box: int = 40
) -> FrameAnnotation:
    """Recover the reference's drawn marks from one annotated frame.

    Boxes: red connected components that look like hollow rectangle
    outlines (both sides >= ``min_box``).  An UNKNOWN face additionally
    gets a red filled label background drawn touching its box
    (``useless/scan.py:286-309``), which merges with the outline into
    one component and inflates its bbox (observed on mayun: a 62 px box
    read as 156x88).  Labels are separated STRUCTURALLY: within a
    component, a run of >= 8 consecutive rows that are >60% red is a
    label band (labels are ~17-27 px tall solid fills; box edges are
    2-4 px thick), erased before taking the box bbox.  Recognized: a
    cyan component with label geometry (filled, wide, 8-40 px tall --
    ``cv2.getTextSize`` at 0.6/2 yields ~17-24 px) sitting directly
    above some box with horizontal overlap.  Requiring adjacency keeps
    footage that naturally contains cyan (mayun's caption band) from
    reading as recognized -- though for such footage the recognized bit
    is still best left unused (module docstring).
    """
    import cv2

    red, cyan = _red_cyan_masks(frame)
    ann = FrameAnnotation()
    n, labmap, stats, _ = cv2.connectedComponentsWithStats(red, 8)
    for i in range(1, n):
        x, y, w, h, area = (int(v) for v in stats[i])
        if w < min_box or h < min_box:
            continue
        comp = (labmap[y : y + h, x : x + w] == i)
        # Close before the row statistics: the label's white TEXT pokes
        # holes in its red fill, dropping its rows under the solidity
        # threshold (frame-500 mayun: "Unknown (0.68)" left label rows
        # at ~55% red).  The bbox is still taken from the unclosed mask.
        closed = cv2.morphologyEx(
            comp.astype(np.uint8), cv2.MORPH_CLOSE, np.ones((7, 7), np.uint8)
        ).astype(bool)
        rowcounts = closed.sum(axis=1)
        solid = rowcounts > 0.6 * w
        # Erase label bands: solid-row runs of >= 8 rows.
        run = 0
        for j in range(h + 1):
            if j < h and solid[j]:
                run += 1
                continue
            if run >= 8:
                comp[j - run : j, :] = False
            run = 0
        ys, xs = np.nonzero(comp)
        if ys.size == 0:
            continue
        bx, by = int(xs.min()), int(ys.min())
        bw = int(xs.max()) - bx + 1
        bh = int(ys.max()) - by + 1
        if bw < min_box or bh < min_box:
            continue
        if ys.size / float(bw * bh) < 0.35:  # hollow outline, not a fill
            # Inset by 2 px/side: the mask bbox spans the thickness-2
            # stroke plus ~1 px of chroma bleed around the geometric
            # rectangle cv2.rectangle was given; the scan records that
            # geometric rectangle, so compare like with like.
            ann.boxes.append((x + bx + 2, y + by + 2, bw - 4, bh - 4))
    if not ann.boxes:
        return ann
    n, _, stats, _ = cv2.connectedComponentsWithStats(cyan, 8)
    for i in range(1, n):
        x, y, w, h, area = (int(v) for v in stats[i])
        if not (8 <= h <= 40 and w >= 40 and area / float(w * h) > 0.5):
            continue
        for bx, by, bw, bh in ann.boxes:
            overlap = min(x + w, bx + bw) - max(x, bx)
            if overlap > min(w, bw) * 0.5 and -12 <= (by - (y + h)) <= 24:
                ann.recognized = True
                break
    return ann


def extract_annotations(
    video_path: str, max_frames: Optional[int] = None, min_box: int = 40
) -> List[FrameAnnotation]:
    """Per-frame annotation recovery over a shipped output video."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    out: List[FrameAnnotation] = []
    while max_frames is None or len(out) < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(extract_frame_annotations(frame, min_box))
    cap.release()
    return out


# ---------------------------------------------------------------------------
# Our side: exact-f64 dual-model scan records
# ---------------------------------------------------------------------------


class DualRecognizerNp:
    """Host-side float64 v1 recognition, bit-faithful to the reference
    (``useless/scan.py:58-166``): crop -> resize(face_dim) -> flatten
    f64 -> center -> project -> cosine vs every gallery row -> max; OR
    over models, higher similarity names the face.

    Pure NumPy on purpose: the per-frame cost is ~1 MFLOP (nothing for
    the host), and it is an oracle that shares no code with the device
    path it is held against.
    """

    def __init__(self, model_paths: Sequence[str]):
        from face_detection_recognization_pca_tpu_torch.io.artifacts import (
            load_model,
        )

        self.models = []
        for p in model_paths:
            art = load_model(p)
            comp = np.asarray(art.components, dtype=np.float64)  # (k, d)
            mean = np.asarray(art.mean_face, dtype=np.float64)  # (d,)
            gallery = np.asarray(art.features, dtype=np.float64)  # (n, k)
            gnorm = np.linalg.norm(gallery, axis=1)
            side = int(round(float(np.sqrt(mean.shape[0]))))
            self.models.append(
                (art.person_name or "unknown", comp, mean, gallery, gnorm, side)
            )

    def best_similarity(self, roi_gray: np.ndarray) -> Tuple[str, float]:
        """Dual OR: (name-of-better-model, best cosine)."""
        import cv2

        best_name, best = "unknown", -1.0
        for name, comp, mean, gallery, gnorm, side in self.models:
            vec = (
                cv2.resize(roi_gray, (side, side))
                .flatten()
                .astype(np.float64)
            )
            proj = (vec - mean) @ comp.T  # (k,)
            pn = np.linalg.norm(proj)
            denom = pn * gnorm
            with np.errstate(invalid="ignore", divide="ignore"):
                cos = np.where(denom > 0, gallery @ proj / denom, 0.0)
            conf = float(cos.max()) if cos.size else 0.0
            if conf > best:
                best_name, best = name, conf
        return best_name, best


def decide_frame(
    gray: np.ndarray,
    faces: Sequence[Box],
    recognizer: DualRecognizerNp,
    threshold: float = 0.8,
    min_annotation_box: int = 200,
    min_unknown_confidence: float = 0.3,
) -> FrameAnnotation:
    """Apply the reference's per-face decision + annotation filter
    (``useless/scan.py:270-330``) and return what WOULD be drawn:
    square boxes + a recognized bit (any cyan label on the frame)."""
    ann = FrameAnnotation()
    for (x, y, w, h) in faces:
        roi = gray[y : y + h, x : x + w]
        if roi.size == 0:
            continue
        _, conf = recognizer.best_similarity(roi)
        is_recognized = conf >= threshold
        if (conf < min_unknown_confidence and not is_recognized) or (
            w < min_annotation_box or h < min_annotation_box
        ):
            continue
        size = max(w, h)
        sx = x + (w - size) // 2
        sy = y + (h - size) // 2
        # Record the VISIBLE part of the square: cv2.rectangle clips at
        # the frame edge, and the extractor can only see drawn pixels --
        # mayun's near-top faces otherwise score ~0.55 IoU purely from
        # comparing an unclipped square against its clipped rendering.
        fh, fw = gray.shape[:2]
        x0, y0 = max(sx, 0), max(sy, 0)
        x1, y1 = min(sx + size, fw), min(sy + size, fh)
        if x1 <= x0 or y1 <= y0:
            continue
        ann.boxes.append((x0, y0, x1 - x0, y1 - y0))
        if is_recognized:
            ann.recognized = True
    return ann


def scan_dual_records(
    video_path: str,
    model_paths: Sequence[str],
    detector=None,
    max_frames: Optional[int] = None,
    threshold: float = 0.8,
    min_annotation_box: int = 200,
    batch: Optional[int] = None,
    device=None,
) -> List[FrameAnnotation]:
    """Run the v1 dual scan and return per-frame drawn-annotation
    records (no video written -- this is the oracle-comparison path).

    ``batch=None``: per-frame ``detect_multi_scale``.
    ``batch=B``: the pipelined ``detect_device``/``detect_finish`` Haar
    path on batches of ``B`` frames, batch N + 1's device half issued
    before batch N's host half; the records are the same.
    ``detector=None`` builds a :class:`HaarDetector` on ``device``
    (``None``: the CUDA device).
    """
    import cv2

    from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector

    detector = detector or HaarDetector(device=device)
    recognizer = DualRecognizerNp(model_paths)

    from face_detection_recognization_pca_tpu_torch.io.video import VideoReader

    reader = VideoReader(video_path)
    out: List[FrameAnnotation] = []

    def decide(gray, faces):
        out.append(
            decide_frame(
                gray,
                faces,
                recognizer,
                threshold=threshold,
                min_annotation_box=min_annotation_box,
            )
        )

    if batch is None:
        for frame in reader.frames():
            if max_frames is not None and len(out) >= max_frames:
                break
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            decide(gray, detector.detect_multi_scale(gray, 1.1, 5, (30, 30)))
        reader.close()
        return out

    pending = None  # (handle, grays)

    def finish(pend):
        handle, grays = pend
        dets_pb = detector.detect_finish(handle)
        for g, faces in zip(grays, dets_pb):
            decide(g, faces)

    grays: List[np.ndarray] = []
    n_read = 0
    for frame in reader.frames():
        if max_frames is not None and n_read >= max_frames:
            break
        grays.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
        n_read += 1
        if len(grays) == batch:
            handle = detector.detect_device(np.stack(grays))
            if pending is not None:
                finish(pending)
            pending = (handle, grays)
            grays = []
    if grays:  # tail partial batch
        handle = detector.detect_device(np.stack(grays))
        if pending is not None:
            finish(pending)
        pending = (handle, grays)
    if pending is not None:
        finish(pending)
    reader.close()
    return out


# ---------------------------------------------------------------------------
# Agreement scoring
# ---------------------------------------------------------------------------


def _iou(a: Box, b: Box) -> float:
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    ix = max(0, min(ax + aw, bx + bw) - max(ax, bx))
    iy = max(0, min(ay + ah, by + bh) - max(ay, by))
    inter = ix * iy
    union = aw * ah + bw * bh - inter
    return inter / union if union > 0 else 0.0


def score_agreement(
    ref: Sequence[FrameAnnotation],
    ours: Sequence[FrameAnnotation],
    use_recognized: bool = True,
) -> Dict[str, float]:
    """Frame-set agreement + box IoU between the extracted reference
    annotations and our scan records (paired by frame index).

    * ``boxed_jaccard``: |both drew a box| / |either drew a box|;
    * ``recognized_jaccard``: same over the recognized-frame sets;
    * ``mean_iou``: per frame where both drew, the best-pairing IoU of
      our boxes vs the reference's, averaged.
    """
    n = min(len(ref), len(ours))
    ref, ours = ref[:n], ours[:n]
    r_boxed = {i for i in range(n) if ref[i].boxes}
    o_boxed = {i for i in range(n) if ours[i].boxes}
    both = r_boxed & o_boxed
    either = r_boxed | o_boxed
    ious = []
    for i in both:
        for rb in ref[i].boxes:
            ious.append(max(_iou(rb, ob) for ob in ours[i].boxes))
    out = {
        "frames": n,
        "ref_boxed": len(r_boxed),
        "our_boxed": len(o_boxed),
        "boxed_jaccard": round(len(both) / len(either), 3) if either else 1.0,
        "mean_iou": round(float(np.mean(ious)), 3) if ious else 0.0,
    }
    if use_recognized:
        r_rec = {i for i in range(n) if ref[i].recognized}
        o_rec = {i for i in range(n) if ours[i].recognized}
        u = r_rec | o_rec
        out.update(
            ref_recognized=len(r_rec),
            our_recognized=len(o_rec),
            recognized_jaccard=(
                round(len(r_rec & o_rec) / len(u), 3) if u else 1.0
            ),
        )
    return out


def find_shipped_output(reference_root: str, stem: str) -> Optional[str]:
    """Locate ``output/recognized*_{stem}_*.mp4`` for a given input
    video stem (timestamps in the shipped names vary)."""
    outdir = os.path.join(reference_root, "output")
    if not os.path.isdir(outdir):
        return None
    for name in sorted(os.listdir(outdir)):
        if name.startswith("recognized") and f"_{stem}_" in name and name.endswith(".mp4"):
            return os.path.join(outdir, name)
    return None
