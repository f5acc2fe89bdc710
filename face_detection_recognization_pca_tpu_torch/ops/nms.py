"""Detection post-processing over fixed slots (port of ``ops/nms.py``).

* IoU greedy NMS -- highest confidence first, drop overlaps >= threshold;
* ``cv2.dnn.NMSBoxes`` semantics -- strict score gate, drop overlaps >
  threshold;
* border / corner rejection -- drop detections touching the 5% frame
  border or centred in a 15% corner square.

Empty slots carry a score at or below ``NEG_INF / 2`` and are never kept.
The greedy pass runs on the host over a mask computed on the boxes'
device: it is a chain of dependent decisions over a few slots.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU for ``(N, 4)`` boxes as (x, y, w, h)."""
    x0 = boxes[:, 0]
    y0 = boxes[:, 1]
    x1 = boxes[:, 0] + boxes[:, 2]
    y1 = boxes[:, 1] + boxes[:, 3]
    ix0 = torch.maximum(x0[:, None], x0[None, :])
    iy0 = torch.maximum(y0[:, None], y0[None, :])
    ix1 = torch.minimum(x1[:, None], x1[None, :])
    iy1 = torch.minimum(y1[:, None], y1[None, :])
    iw = torch.clamp(ix1 - ix0, min=0.0)
    ih = torch.clamp(iy1 - iy0, min=0.0)
    inter = iw * ih
    area = boxes[:, 2] * boxes[:, 3]
    union = area[:, None] + area[None, :] - inter
    positive = union > 0
    return torch.where(positive, inter / torch.where(positive, union, torch.ones_like(union)), 0.0)


def _greedy(scores: torch.Tensor, gate: torch.Tensor, overlaps: torch.Tensor) -> torch.Tensor:
    # Visit slots by descending score; the sort is stable, so equal scores
    # keep the lowest index first.  A slot is kept if it passes the gate
    # and nothing kept before it overlaps it.
    order = torch.argsort(-scores, stable=True).cpu().numpy()
    gate = gate.cpu().numpy()
    overlaps = overlaps.cpu().numpy()
    n = order.shape[0]
    keep = np.zeros(n, dtype=bool)
    suppressed = np.zeros(n, dtype=bool)
    for idx in order:
        if suppressed[idx] or not gate[idx]:
            continue
        keep[idx] = True
        row = overlaps[idx].copy()
        row[idx] = False
        suppressed |= row
    return torch.from_numpy(keep).to(scores.device)


def nms(
    boxes: torch.Tensor, scores: torch.Tensor, overlap_threshold: float = 0.3
) -> torch.Tensor:
    """Greedy IoU NMS: ``(N,)`` bool keep mask for ``(N, 4)`` boxes as
    (x, y, w, h) and ``(N,)`` scores.  A kept box suppresses every later
    one with IoU ``>=`` the threshold (the reference's loop keeps only
    IoU strictly below it)."""
    iou = iou_matrix(boxes.to(torch.float32))
    return _greedy(scores, scores > NEG_INF / 2, iou >= overlap_threshold)


def nms_boxes_cv2(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    score_threshold: float,
    nms_threshold: float,
) -> torch.Tensor:
    """``cv2.dnn.NMSBoxes`` semantics as a keep mask: boxes with
    ``score == score_threshold`` are dropped (strict ``>``), suppression
    fires only at ``IoU > nms_threshold`` (a pair exactly at the threshold
    survives), and equal scores keep the lowest index."""
    iou = iou_matrix(boxes.to(torch.float32))
    return _greedy(scores, scores > score_threshold, iou > nms_threshold)


def in_border_or_corner(
    boxes: torch.Tensor,
    frame_width: int,
    frame_height: int,
    corner_threshold: float = 0.15,
    border_threshold: float = 0.05,
) -> torch.Tensor:
    """Bool ``(N,)``: True where an (x, y, w, h) box touches a border strip
    or its centre lies in a corner square.  The strip and square sizes are
    the products floored (``int(size * share)`` in double precision, as
    the reference and the JAX package under x64 take them) and the centres
    are ``x + w // 2``, like the reference."""
    x = boxes[:, 0]
    y = boxes[:, 1]
    w = boxes[:, 2]
    h = boxes[:, 3]

    def floored(size: int, share: float) -> float:
        return float(math.floor(size * share))

    corner_w = floored(frame_width, corner_threshold)
    corner_h = floored(frame_height, corner_threshold)
    border_w = floored(frame_width, border_threshold)
    border_h = floored(frame_height, border_threshold)
    cx = x + torch.div(w, 2, rounding_mode="floor")
    cy = y + torch.div(h, 2, rounding_mode="floor")

    on_border = (
        (x < border_w)
        | (y < border_h)
        | ((x + w) > (frame_width - border_w))
        | ((y + h) > (frame_height - border_h))
    )
    tl = (cx < corner_w) & (cy < corner_h)
    tr = (cx > (frame_width - corner_w)) & (cy < corner_h)
    bl = (cx < corner_w) & (cy > (frame_height - corner_h))
    br = (cx > (frame_width - corner_w)) & (cy > (frame_height - corner_h))
    return on_border | tl | tr | bl | br
