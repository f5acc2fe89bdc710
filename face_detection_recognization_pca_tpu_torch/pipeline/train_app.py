"""Training stage: crops (+ detection JSON) -> PCA model artifacts (port
of ``pipeline/train_app.py``).

Covers both reference trainers:

* single person (``train-v4.py``): crops listed in the detection JSON,
  gray -> 64x64 -> flatten, z-score + PCA(k=50), artifacts
  ``face_model.pkl`` + ``{person}_model_info.json`` + eigenface JPEGs in
  the person dir;
* multi person (``train-v5.py``): every person dir under the lock root
  (detection JSONs auto-backfilled when missing,
  ``train-v5.py:220-223``), integer labels via ``person_id_map``,
  a combined ``multi_person_*`` model, and per-person models with
  ``n_components = face_count`` capped at the centered-data rank
  (matching the shipped 77-faces/76-components artifact).

:func:`train_person_crops` is the body that needs no file: crops in
memory and their detection records in, an artifact out.  The crops are
preprocessed on the device (OpenCV's exact gray and resize), one batch
per crop shape, and the PCA (``train_v2``) runs there too, in the
config's ``train.dtype``.  The file forms read the JPEGs with OpenCV and
call it.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.config import PipelineConfig
from face_detection_recognization_pca_tpu_torch.device import resolve_device
from face_detection_recognization_pca_tpu_torch.io.artifacts import (
    EigenfacesArtifact,
    save_model_v2,
    write_model_info_json,
)
from face_detection_recognization_pca_tpu_torch.io.detection_json import (
    generate_detection_json,
    read_detection_json,
)
from face_detection_recognization_pca_tpu_torch.io.images import imread_bgr, save_eigenface_images
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as ef
from face_detection_recognization_pca_tpu_torch.ops.preprocess import preprocess_crops
from face_detection_recognization_pca_tpu_torch.utils.logging import get_logger

log = get_logger("fdrp.train")

Device = Optional[Union[str, torch.device]]


def crop_vectors(
    crops: Sequence[np.ndarray], face_size: Tuple[int, int], device: torch.device
) -> torch.Tensor:
    """uint8 BGR (or gray) host crops -> ``(n, w * h)`` float64 face
    vectors on ``device`` in the crops' order, OpenCV-exact; one
    preprocessing batch per crop shape.  ``face_size`` is ``(w, h)``."""
    groups: Dict[tuple, List[int]] = {}
    for i, c in enumerate(crops):
        groups.setdefault(c.shape, []).append(i)
    out = torch.empty((len(crops), face_size[0] * face_size[1]), dtype=torch.float64,
                      device=device)
    for idx in groups.values():
        batch = torch.from_numpy(np.stack([crops[i] for i in idx])).to(device)
        out[torch.tensor(idx, device=device)] = preprocess_crops(
            batch, face_size, exact=True, dtype=torch.float64)
    return out


def _load_person_crops(
    person_dir: str, person_name: str, regenerate_json: bool = True
) -> Tuple[List[np.ndarray], List[dict]]:
    """Crops referenced by the person's detection JSON, read as BGR, and
    their face_info records."""
    json_path = os.path.join(person_dir, f"{person_name}_faces_detection.json")
    if not os.path.exists(json_path) and regenerate_json:
        log.info("backfilling detection JSON for %s", person_name)
        generate_detection_json(person_dir, person_name, output_path=json_path)
    det = read_detection_json(json_path)
    crops, info = [], []
    for rec in det.faces:
        path = rec.image_path
        if not os.path.exists(path):
            # Windows-style or relocated paths: resolve by basename.
            path = os.path.join(person_dir, os.path.basename(str(rec.image_path).replace("\\", "/")))
        img = imread_bgr(path)
        if img is None:
            log.warning("skipping unreadable crop %s", rec.image_path)
            continue
        crops.append(img)
        info.append(rec.__dict__.copy())
    if not crops:
        raise ValueError(f"no readable crops for {person_name}")
    return crops, info


def _effective_k(requested: int, n_samples: int, d: int) -> int:
    # Centered data has rank <= n-1; sklearn's full SVD likewise yields
    # n-1 useful components (the shipped 77-crop model stores 76).
    return max(1, min(requested, n_samples - 1 if n_samples > 1 else 1, d))


def _train(
    vecs: torch.Tensor, labels: torch.Tensor, k: int, face_shape, dtype: torch.dtype, **meta
) -> EigenfacesArtifact:
    model, aux = ef.train_v2(vecs.to(dtype), labels, n_components=k, face_shape=tuple(face_shape))
    return ef.to_artifact(model, aux, training_date=datetime.now().isoformat(), **meta)


def train_person_crops(
    crops: Sequence[np.ndarray],
    face_info: List[dict],
    person_name: str,
    config: Optional[PipelineConfig] = None,
    device: Device = None,
) -> EigenfacesArtifact:
    """train-v4 parity on crops in memory: one person, labels all zero,
    computed on ``device`` (``None``: the CUDA device)."""
    cfg = config or PipelineConfig()
    device = resolve_device(device)
    face_hw = cfg.train.face_size
    vecs = crop_vectors(crops, (face_hw[1], face_hw[0]), device)
    k = _effective_k(cfg.train.n_components, vecs.shape[0], vecs.shape[1])
    labels = torch.zeros(vecs.shape[0], dtype=torch.int32, device=device)
    return _train(vecs, labels, k, face_hw, getattr(torch, cfg.train.dtype),
                  person_id_map={person_name: 0}, person_name=person_name, face_info=face_info)


def save_person_model(art: EigenfacesArtifact, person_dir: str, person_name: str) -> None:
    """``face_model.pkl`` and ``{person}_model_info.json`` in the person dir."""
    save_model_v2(art, os.path.join(person_dir, "face_model.pkl"))
    write_model_info_json(art, os.path.join(person_dir, f"{person_name}_model_info.json"))


def train_single_person(
    person_name: str,
    lock_dir: Optional[str] = None,
    config: Optional[PipelineConfig] = None,
    save: bool = True,
    device: Device = None,
) -> EigenfacesArtifact:
    """train-v4 parity: one person, labels all zero; the crops listed in
    the person's detection JSON are read with OpenCV."""
    cfg = config or PipelineConfig()
    lock = lock_dir or cfg.paths.lock_dir
    person_dir = os.path.join(lock, person_name)
    crops, info = _load_person_crops(person_dir, person_name)
    art = train_person_crops(crops, info, person_name, cfg, device)
    if save:
        save_person_model(art, person_dir, person_name)
        save_eigenface_images(
            art.components,
            art.mean_face,
            art.face_shape,
            person_dir,
            prefix=f"{person_name}_",
            top_k=cfg.train.eigenfaces_to_save,
        )
        log.info(
            "trained %s: %d faces, k=%d, EVR=%.3f",
            person_name,
            len(crops),
            art.n_components,
            float(np.sum(art.explained_variance_ratio)),
        )
    return art


def train_all_persons(
    lock_dir: Optional[str] = None,
    config: Optional[PipelineConfig] = None,
    per_person_components: Optional[int] = None,
    combined: bool = True,
    save: bool = True,
    device: Device = None,
) -> Dict[str, EigenfacesArtifact]:
    """train-v5 parity: per-person models (k=face count) + a combined
    multi-person model over all dirs, on ``device`` (``None``: the CUDA
    device).  The per-person and combined models train in float64, as the
    JAX package's do.

    ``save=False`` skips every artifact write (model pickles, info
    JSONs, eigenface JPEGs), to retrain against a read-only gallery
    tree."""
    cfg = config or PipelineConfig()
    device = resolve_device(device)
    lock = lock_dir or cfg.paths.lock_dir
    persons = sorted(p for p in os.listdir(lock) if os.path.isdir(os.path.join(lock, p)))
    out: Dict[str, EigenfacesArtifact] = {}
    all_vecs, all_labels, person_id_map, all_info = [], [], {}, []
    face_hw = cfg.train.face_size
    for pid, person in enumerate(persons):
        try:
            crops, info = _load_person_crops(os.path.join(lock, person), person)
        except ValueError as e:
            log.warning("skipping %s: %s", person, e)
            continue
        vecs = crop_vectors(crops, (face_hw[1], face_hw[0]), device)
        person_id_map[person] = pid
        all_vecs.append(vecs)
        all_labels.append(torch.full((vecs.shape[0],), pid, dtype=torch.int32, device=device))
        all_info.extend(info)

        # Per-person model, k = face count (train-v5.py:540-545).
        k = _effective_k(per_person_components or vecs.shape[0], vecs.shape[0], vecs.shape[1])
        art = _train(vecs, torch.zeros(vecs.shape[0], dtype=torch.int32, device=device), k,
                     face_hw, torch.float64, person_id_map={person: 0}, person_name=person,
                     face_info=info)
        if save:
            save_person_model(art, os.path.join(lock, person), person)
        out[person] = art

    if combined and all_vecs:
        x = torch.cat(all_vecs)
        y = torch.cat(all_labels)
        k = _effective_k(cfg.train.n_components * 2, x.shape[0], x.shape[1])
        art = _train(x, y, k, face_hw, torch.float64, person_id_map=person_id_map,
                     person_name="multi_person", face_info=all_info)
        if save:
            models_dir = cfg.paths.models_dir
            os.makedirs(models_dir, exist_ok=True)
            save_model_v2(art, os.path.join(models_dir, "multi_person_face_model.pkl"))
            write_model_info_json(art, os.path.join(models_dir, "multi_person_model_info.json"))
            save_eigenface_images(
                art.components,
                art.mean_face,
                art.face_shape,
                models_dir,
                prefix="multi_person_",
                top_k=cfg.train.eigenfaces_to_save,
            )
        out["multi_person"] = art
    return out
