"""The Haar scan's answers judged against the reference: the boxes of
every frame, and each record's person and cosine, recognised again by the
reference's own models on the program's box."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .eigenfaces import Model, cosines, face_vectors
from .numerics import Arith

Box = Tuple[int, int, int, int]


def box_deviation(got: Sequence[Box], want: Sequence[Box]) -> float:
    """The largest distance in px, by the worst of x, y, w and h, between a
    box and its partner, pairing the closest first; a box left without a
    partner counts its larger side."""
    got, want = [np.asarray(b, float) for b in got], [np.asarray(b, float) for b in want]
    worst = 0.0
    while got and want:
        d = np.array([[np.abs(g - w).max() for w in want] for g in got])
        i, j = np.unravel_index(np.argmin(d), d.shape)
        worst = max(worst, float(d[i, j]))
        got.pop(i)
        want.pop(j)
    for box in got + want:
        worst = max(worst, float(max(box[2], box[3])))
    return worst


def best_per_model(models: Sequence[Model], crops: List[np.ndarray], face_hw, ar: Arith,
                   device) -> np.ndarray:
    """``(len(crops), M)`` each model's best gallery cosine per crop."""
    vectors = face_vectors(crops, face_hw, ar, device)
    return np.stack([cosines(m, vectors, ar).max(dim=1).values.to(torch.float64).cpu().numpy()
                     for m in models], axis=1)


def recognition_error(records: Sequence[dict], best: np.ndarray, names: Sequence[str],
                      threshold: float, unknown: str) -> float:
    """The largest over ``records`` of how far each lies from the scan's
    rule on the reference's cosines: the best person's cosine is the
    confidence; at or above ``threshold`` the record names that person with
    id 0, below it the record is ``unknown`` with id -1.  A named record
    reads how far the named person's cosine lies below the best, or its
    confidence from that cosine, or that cosine below the threshold,
    whichever is largest; an ``unknown`` one reads its confidence from the
    best cosine, or the best cosine above the threshold, whichever is
    larger; a person id that does not go with the name reads 1."""
    worst = 0.0
    for record, cos in zip(records, best):
        top = float(cos.max())
        if not np.isfinite(top):  # an empty crop: unknown, confidence 0
            named = record["person_name"] != unknown or record["person_id"] != -1
            worst = max(worst, 1.0 if named else abs(record["confidence"]))
            continue
        if record["person_name"] in names:
            c = float(cos[names.index(record["person_name"])])
            err = max(top - c, abs(record["confidence"] - c), threshold - c)
            err = err if record["person_id"] == 0 else max(err, 1.0)
        else:
            err = max(abs(record["confidence"] - top), top - threshold)
            err = err if record["person_id"] == -1 and record["person_name"] == unknown \
                else max(err, 1.0)
        worst = max(worst, err)
    return worst


def judge(calls: Sequence[Tuple[int, List[dict]]], frames: np.ndarray, boxes: List[List[Box]],
          models: Sequence[Model], names: Sequence[str], batch: int, face_hw, threshold: float,
          unknown: str, max_faces: int, ar: Arith, device) -> Dict[str, float]:
    """``calls``: per call its index and records.  ``frames`` is the pool
    of BGR frames the calls cycled through, ``boxes`` the reference's
    boxes of each.  Returns ``box_err``, the sum over the pool's frames of
    each frame's worst :func:`box_deviation` over all its answers, and
    ``recog_err``, :func:`recognition_error` over every record."""
    pool = len(frames)
    worst = np.zeros(pool)
    records, keys = [], []
    for index, recs in calls:
        by_frame: Dict[int, List[Box]] = {}
        for r in recs:
            by_frame.setdefault(r["frame_number"], []).append((r["x"], r["y"], r["width"], r["height"]))
        for j in range(batch):
            frame = (index * batch + j) % pool
            worst[frame] = max(worst[frame], box_deviation(by_frame.get(j, []),
                                                           boxes[frame][:max_faces]))
        for r in recs:
            records.append(r)
            keys.append(((index * batch + r["frame_number"]) % pool,
                         r["x"], r["y"], r["width"], r["height"]))
    recog = 0.0
    if records:
        # Each distinct crop (a frame of the pool and a box) is recognised once.
        unique = sorted(set(keys))
        crops = [frames[f][max(y, 0):y + h, max(x, 0):x + w] for f, x, y, w, h in unique]
        empty = [c.size == 0 for c in crops]
        best = np.full((len(unique), len(models)), -np.inf)
        if not all(empty):
            best[~np.array(empty)] = best_per_model(
                models, [c for c, e in zip(crops, empty) if not e], face_hw, ar, device)
        row = {key: n for n, key in enumerate(unique)}
        recog = recognition_error(records, best[[row[k] for k in keys]], names, threshold,
                                  unknown)
    return {"box_err": float(worst.sum()), "recog_err": recog}
