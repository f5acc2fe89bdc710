"""Accuracy evaluation: top-1 match accuracy, holdout splits,
cross-lighting model selection (port of ``pipeline/eval_app.py``).

The reference never measures accuracy (SURVEY §4: verification was
eyeballing annotated videos).  BASELINE.json names "top-1 match acc" a
metric of record and config 3 asks for per-lighting-condition model
selection/eval, so the JAX package added the missing harness:

* :func:`evaluate_model` -- top-1 accuracy of an eigenfaces model over
  labeled crops (one ``recognize`` per crop shape, on the model's device);
* :func:`holdout_eval` -- train a multi-person model on a split of the
  lock-dir crops and score the held-out remainder;
* :func:`cross_lighting_eval` -- score every (model, condition) pair,
  reproducing the dark/light/lock model-selection question as a matrix.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.config import PipelineConfig
from face_detection_recognization_pca_tpu_torch.device import resolve_device
from face_detection_recognization_pca_tpu_torch.io.images import imread_bgr
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as ef
from face_detection_recognization_pca_tpu_torch.pipeline.train_app import crop_vectors
from face_detection_recognization_pca_tpu_torch.utils.logging import get_logger

log = get_logger("fdrp.eval")


def _load_crops(person_dir: str, limit: Optional[int] = None) -> List[np.ndarray]:
    """All crop images in a person dir, skipping model artifacts --
    the train-v5 listing rule (crop prefixes vary across generations:
    ``face_*`` vs ``detected_face_*``)."""
    skip = ("eigenface", "mean_face", "model_info")
    paths = sorted(
        p
        for p in glob.glob(os.path.join(person_dir, "*.jpg"))
        if not any(tok in os.path.basename(p).lower() for tok in skip)
    )
    if limit:
        paths = paths[:limit]
    out = []
    for p in paths:
        img = imread_bgr(p)
        if img is not None:
            out.append(img)
    return out


def evaluate_model(
    model: ef.EigenfacesModel,
    crops: Sequence[np.ndarray],
    true_ids: Sequence[int],
    threshold: float = 0.0,
    exact: bool = True,
) -> Dict[str, float]:
    """Top-1 accuracy + confidence stats for labeled host crops, on the
    model's device: one ``ef.recognize`` per distinct crop shape."""
    assert len(crops) == len(true_ids)
    n = len(crops)
    pred = np.full(n, -1, dtype=np.int64)
    confs = np.zeros(n)
    groups: Dict[tuple, List[int]] = {}
    for i, c in enumerate(crops):
        groups.setdefault(c.shape, []).append(i)
    device = model.components.device
    for idxs in groups.values():
        batch = torch.from_numpy(np.stack([crops[i] for i in idxs])).to(device)
        ids, conf = ef.recognize(model, batch, threshold, exact=exact)
        pred[idxs] = ids.cpu().numpy()
        confs[idxs] = conf.cpu().numpy()
    true = np.asarray(true_ids)
    return {
        "n": n,
        "top1_accuracy": float((pred == true).sum() / n) if n else 0.0,
        "reject_rate": float((pred == -1).sum() / n) if n else 0.0,
        "mean_confidence": float(confs.mean()) if n else 0.0,
    }


def holdout_eval(
    lock_dir: str,
    holdout_every: int = 5,
    n_components: int = 100,
    max_per_person: Optional[int] = None,
    config: Optional[PipelineConfig] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, float]:
    """Train multi-person on (1 - 1/holdout_every) of crops, score the rest,
    on ``device`` (``None``: the CUDA device), in float64.

    Returns the evaluation dict plus per-person accuracies."""
    cfg = config or PipelineConfig()
    device = resolve_device(device)
    persons = sorted(
        p for p in os.listdir(lock_dir) if os.path.isdir(os.path.join(lock_dir, p))
    )
    train_crops, train_labels = [], []
    eval_crops, eval_ids = [], []
    person_id_map = {}
    face_hw = cfg.train.face_size
    for pid, person in enumerate(persons):
        crops = _load_crops(os.path.join(lock_dir, person), max_per_person)
        if len(crops) < holdout_every:
            log.warning("skipping %s (only %d crops)", person, len(crops))
            continue
        person_id_map[person] = pid
        for i, c in enumerate(crops):
            if i % holdout_every == 0:
                eval_crops.append(c)
                eval_ids.append(pid)
            else:
                train_crops.append(c)
                train_labels.append(pid)
    x = crop_vectors(train_crops, (face_hw[1], face_hw[0]), device)
    y = torch.tensor(train_labels, dtype=torch.int32, device=device)
    k = max(1, min(n_components, x.shape[0] - 1, x.shape[1]))
    model, _ = ef.train_v2(x, y, k, face_shape=tuple(face_hw))

    t0 = time.perf_counter()
    stats = evaluate_model(model, eval_crops, eval_ids)
    stats["eval_wall_s"] = round(time.perf_counter() - t0, 3)
    per_person = {}
    for person, pid in person_id_map.items():
        sel = [i for i, t in enumerate(eval_ids) if t == pid]
        if sel:
            sub = evaluate_model(model, [eval_crops[i] for i in sel], [pid] * len(sel))
            per_person[person] = sub["top1_accuracy"]
    stats["per_person"] = per_person
    stats["n_train"] = int(x.shape[0])
    stats["n_components"] = k
    stats["persons"] = len(person_id_map)
    return stats


def cross_lighting_eval(
    models: Dict[str, ef.EigenfacesModel],
    datasets: Dict[str, Tuple[Sequence[np.ndarray], Sequence[int]]],
    threshold: float = 0.0,
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Every model scored on every condition: the dark/light/lock
    model-selection matrix (BASELINE config 3)."""
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for mname, model in models.items():
        out[mname] = {}
        for dname, (crops, ids) in datasets.items():
            out[mname][dname] = evaluate_model(model, crops, ids, threshold)
    return out
