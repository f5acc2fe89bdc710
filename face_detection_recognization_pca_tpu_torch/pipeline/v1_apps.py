"""v1-generation apps: dark/light snapshot-PCA training + dual-model scan
(port of ``pipeline/v1_apps.py``).

Reference parity:

* ``useless/train.py``: per-version training over bare image dirs
  (grayscale, NO resize, float64), snapshot PCA, artifacts
  ``{person}_{version}_pca_model.pkl`` + ``..._model_info.json`` (top-10
  EVR list) + eigenface JPEGs named ``{person}_{version}_...``;
* ``useless/scan.py``: Haar detection per frame, crop -> face_dim
  square -> flatten f64 -> project into both dark and light models,
  cosine vs every gallery row, dual-model OR (best confidence), runtime
  threshold 0.8, annotation filters (drop conf<0.3 unknowns and boxes
  < 200 px), square red box + cyan label, output
  ``output/recognized_dual_{stem}_{timestamp}.mp4`` and running stats.

Both read and write image and video files with OpenCV; the float64
training and projections run on ``device`` (``None``: the CUDA device).
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from face_detection_recognization_pca_tpu_torch.config import PipelineConfig
from face_detection_recognization_pca_tpu_torch.detect.haar import HaarDetector
from face_detection_recognization_pca_tpu_torch.device import resolve_device
from face_detection_recognization_pca_tpu_torch.io.artifacts import load_model, save_model_v1
from face_detection_recognization_pca_tpu_torch.io.images import save_eigenface_images
from face_detection_recognization_pca_tpu_torch.io.video import VideoReader, VideoWriter
from face_detection_recognization_pca_tpu_torch.models import eigenfaces as ef
from face_detection_recognization_pca_tpu_torch.ops.similarity import cosine_gallery
from face_detection_recognization_pca_tpu_torch.recognize.fusion import (
    annotation_filter,
    dual_model_or,
)
from face_detection_recognization_pca_tpu_torch.utils import annotate
from face_detection_recognization_pca_tpu_torch.utils.logging import Counters, get_logger

log = get_logger("fdrp.v1")

Device = Optional[Union[str, torch.device]]


def train_v1_version(
    faces_dir: str,
    person_name: str,
    model_dir: str = "models",
    version: str = "",
    n_components: int = 50,
    device: Device = None,
) -> str:
    """Train one v1 model from a bare directory of stills; returns the
    model path (reference ``useless/train.py:225-275``)."""
    import cv2

    names = sorted(
        n
        for n in os.listdir(faces_dir)
        if n.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))
    )
    vecs, files = [], []
    for n in names:
        img = cv2.imread(os.path.join(faces_dir, n), cv2.IMREAD_GRAYSCALE)
        if img is None:
            log.warning("could not load %s", n)
            continue
        vecs.append(img.flatten().astype(np.float64))
        files.append(n)
    if not vecs:
        raise ValueError(f"no images in {faces_dir}")
    x = torch.from_numpy(np.stack(vecs)).to(resolve_device(device))
    model, aux = ef.train_v1(x, n_components=n_components)
    art = ef.to_artifact(
        model,
        aux,
        person_name=person_name,
        version=version,
        training_filenames=files,
        training_date=datetime.now().isoformat(),
    )
    os.makedirs(model_dir, exist_ok=True)
    suffix = f"{person_name}_{version}" if version else person_name
    model_path = os.path.join(model_dir, f"{suffix}_pca_model.pkl")
    save_model_v1(art, model_path)

    eig = np.asarray(art.eigenvalues)
    meta = {
        "person_name": person_name,
        "version": version,
        "training_timestamp": art.training_date,
        "n_components": int(art.n_components),
        "face_dimensions": int(art.mean_face.shape[0]),
        "n_training_images": len(files),
        "explained_variance_ratio": (eig / eig.sum()).tolist()[:10],
        "model_file": os.path.basename(model_path),
    }
    with open(
        os.path.join(model_dir, f"{suffix}_model_info.json"), "w", encoding="utf-8"
    ) as f:
        json.dump(meta, f, indent=2, ensure_ascii=False)
    save_eigenface_images(
        art.components,
        art.mean_face,
        art.face_shape,
        model_dir,
        prefix=f"{suffix}_",
    )
    log.info(
        "trained v1 %s: %d images, k=%d", suffix, len(files), art.n_components
    )
    return model_path


def train_v1_versions(
    person_name: str = "Joseph_Lai",
    base_faces_dir: str = "faces",
    model_dir: str = "models",
    versions: Sequence[Tuple[str, str]] = (
        ("dark", "Dark_version"),
        ("light", "Light_version"),
    ),
    n_components: int = 50,
    device: Device = None,
) -> List[str]:
    """Dark + light training loop (useless/train.py:278-311)."""
    return [
        train_v1_version(
            os.path.join(base_faces_dir, subdir),
            person_name,
            model_dir,
            version,
            n_components,
            device,
        )
        for version, subdir in versions
    ]


def scan_dual(
    video_path: str,
    model_paths: Sequence[str],
    output_dir: str = "output",
    similarity_threshold: float = 0.8,
    config: Optional[PipelineConfig] = None,
    detector=None,
    max_frames: Optional[int] = None,
    device: Device = None,
) -> dict:
    """Dual-model video scan (useless/scan.py:332-429).  ``detector`` is
    anything with :meth:`HaarDetector.detect_multi_scale`'s signature on a
    host gray frame; ``None`` builds a :class:`HaarDetector` on
    ``device``."""
    import cv2

    cfg = config or PipelineConfig()
    device = resolve_device(device)
    models = []
    for p in model_paths:
        art = load_model(p)
        models.append((art, ef.from_artifact(art, torch.float64, device)))
    detector = detector or HaarDetector(device=device)
    reader = VideoReader(video_path)
    meta = reader.meta
    os.makedirs(output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(video_path))[0]
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    out_path = os.path.join(output_dir, f"recognized_dual_{stem}_{ts}.mp4")
    writer = VideoWriter(out_path, (meta.width, meta.height), meta.fps)
    counters = Counters()
    frame_no = 0
    for frame in reader.frames():
        if max_frames is not None and frame_no >= max_frames:
            break
        counters.inc("frames")
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        faces = detector.detect_multi_scale(
            gray,
            cfg.detect.scale_factor,
            cfg.detect.min_neighbors,
            cfg.detect.min_size,
        )
        if faces:
            counters.inc("frames_with_detection")
        recognized_this_frame = False
        for (x, y, w, h) in faces:
            roi = gray[y : y + h, x : x + w]
            results = []
            for art, model in models:
                side = model.face_shape[0]
                vec = cv2.resize(roi, (side, side)).flatten().astype(np.float64)[None]
                feats = ef.project_vectors(model, torch.from_numpy(vec).to(device))
                conf = float(cosine_gallery(feats, model.gallery)[0].max())
                name = art.person_name or "unknown"
                results.append((0 if conf >= similarity_threshold else -1, name, conf))
            pid, name, conf = dual_model_or(results)
            recognized = pid >= 0 and conf >= similarity_threshold
            display = name if recognized else "unknown"
            if not annotation_filter(display, conf, w, h, cfg.recognize):
                continue
            annotate.draw_v1_square(frame, (x, y, w, h), display, conf)
            if recognized:
                recognized_this_frame = True
        if recognized_this_frame:
            counters.inc("frames_recognized")
        writer.write(frame)
        frame_no += 1
    reader.close()
    writer.close()
    log.info("\n%s", counters.recognition_summary())
    return {
        "output_video": out_path,
        "counters": counters.as_dict(),
        "summary": counters.recognition_summary(),
    }
