"""Guided template search: training-video detections as position priors
(port of ``detect/guided.py``).

Reference semantics (``scripts/manual/scan-template-v2.py:463-523``):
for each reference detection near the current frame number, expand its
box by ``search_scale`` around its centre (clamped to the frame), resize
the training template to the reference box size, run TM_CCOEFF_NORMED
inside the window, and keep the best hit in global coordinates.  The
final detection is the highest-confidence hit across priors; the box
keeps the reference width and height.

The JAX package pads each search window with edge values to a multiple
of ``BUCKET`` and masks the scores of the padded positions, to bound the
number of shapes it compiles.  Nothing is compiled here, but the padding
is kept: the score map's global-mean centring is taken over the padded
window, so dropping it would move the confidences in their last digits,
and with it both packages give the same numbers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.device import resolve_device
from face_detection_recognization_pca_tpu_torch.io.detection_json import (
    DetectionFile,
    reference_positions,
)
from face_detection_recognization_pca_tpu_torch.ops.match import (
    match_template_ccoeff_normed,
)
from face_detection_recognization_pca_tpu_torch.ops.resize import (
    resize_bilinear_u8_exact,
)

BUCKET = 32


def _window_best(
    window: torch.Tensor, template: torch.Tensor, valid_h: int, valid_w: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best NCC hit inside a (possibly padded) search window: ``(score, x,
    y)``.  Positions whose window extends past the valid (unpadded) region
    are masked out, so padding never wins the argmax."""
    scores = match_template_ccoeff_normed(window, template)
    oh, ow = scores.shape
    vh = valid_h - template.shape[0] + 1
    vw = valid_w - template.shape[1] + 1
    rows = torch.arange(oh, device=scores.device)[:, None]
    cols = torch.arange(ow, device=scores.device)[None, :]
    flat = torch.where((rows < vh) & (cols < vw), scores, -torch.inf).reshape(-1)
    idx = torch.argmax(flat)
    return flat[idx], idx % ow, idx // ow


class GuidedMatcher:
    """Stateless guided matcher over one training template.  The score
    maps are computed on ``device`` (``None``: the CUDA device)."""

    def __init__(
        self,
        template_gray: np.ndarray,
        search_scale: float = 1.5,
        device: Optional[torch.device] = None,
    ):
        self.template = np.ascontiguousarray(template_gray, dtype=np.uint8)
        self.search_scale = search_scale
        self.device = resolve_device(device)

    def match_frame(
        self,
        frame_gray: np.ndarray,
        priors: Sequence,
        frame_number: int = 0,
    ) -> Optional[dict]:
        """Best guided hit for one frame given prior detections.

        ``priors``: DetectionRecord-like objects with center_x, center_y,
        width and height (and optionally frame_number).  Returns dict(x, y,
        width, height, confidence, ref_frame_diff) or None, mirroring the
        reference's ``all_matches`` + max, the frame distance of the
        winning prior included."""
        height, width = frame_gray.shape
        template = torch.from_numpy(self.template)
        best = None
        for ref in priors:
            rw, rh = int(ref.width), int(ref.height)
            if rw <= 0 or rh <= 0:
                continue
            search_w = int(rw * self.search_scale)
            search_h = int(rh * self.search_scale)
            sx = max(0, int(ref.center_x) - search_w // 2)
            sy = max(0, int(ref.center_y) - search_h // 2)
            sxe = min(width, sx + search_w)
            sye = min(height, sy + search_h)
            aw, ah = sxe - sx, sye - sy
            if aw <= 0 or ah <= 0 or ah < rh or aw < rw:
                continue
            tmpl = resize_bilinear_u8_exact(template, (rw, rh)).to(self.device, torch.float32)
            # Bucket the window shape: pad with edge values, mask scores.
            bw = -(-aw // BUCKET) * BUCKET
            bh = -(-ah // BUCKET) * BUCKET
            window = frame_gray[sy:sye, sx:sxe].astype(np.float32)
            if bw != aw or bh != ah:
                window = np.pad(window, ((0, bh - ah), (0, bw - aw)), mode="edge")
            conf, lx, ly = (
                v.item()
                for v in _window_best(torch.from_numpy(window).to(self.device), tmpl, ah, aw)
            )
            hit = {
                "x": sx + int(lx),
                "y": sy + int(ly),
                "width": rw,
                "height": rh,
                "confidence": float(conf),
                "ref_frame_diff": abs(
                    int(getattr(ref, "frame_number", frame_number)) - int(frame_number)
                ),
            }
            if best is None or hit["confidence"] > best["confidence"]:
                best = hit
        return best

    def match_with_detection_file(
        self,
        frame_gray: np.ndarray,
        det: DetectionFile,
        frame_number: int,
        tolerance: int = 5,
    ) -> Optional[dict]:
        priors = reference_positions(det, frame_number, tolerance)
        return self.match_frame(frame_gray, priors, frame_number)
